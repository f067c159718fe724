"""Clean twin: the same toy surface declaration, fully covered by
manifest.py."""

LINT_SURFACE = {
    "endpoints": ["momentum", "turnover"],
    "months": 24,
    "asset_buckets": [8],
    "batch_buckets": [1, 4],
}
