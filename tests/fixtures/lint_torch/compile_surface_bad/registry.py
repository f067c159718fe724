"""Known-bad fixture: a toy serving surface (the LINT_SURFACE literal
form the compile-surface rule checks on non-package trees).  The
endpoint x bucket world declared here is larger than the warmed
manifest in manifest.py — one dispatchable shape has no warm entry."""

LINT_SURFACE = {
    "endpoints": ["momentum", "turnover"],
    "months": 24,
    "asset_buckets": [8],
    "batch_buckets": [1, 4],
}
