"""Known-bad fixture: tensors read after being donated to a surface."""

from csmom_tpu_torch.serve.engine import (
    serve_entry_fn_donated)


def run(values, mask):
    fn = serve_entry_fn_donated("momentum", 12, 1, 10, "rank")
    out = fn(values, mask)
    return out + values          # `values` was consumed at the call


def run_named_donated(values, mask, entry_donated):
    out = entry_donated(values, mask)
    checksum = values.sum()      # read-after-donate via a *_donated entry
    return out, checksum
