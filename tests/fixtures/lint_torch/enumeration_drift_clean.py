"""Clean twin: registry queries and a declared checkpoint point."""

from csmom_tpu_torch.chaos.inject import checkpoint
from csmom_tpu_torch.registry import serve_endpoints


def probe():
    for kind in serve_endpoints():    # the registry IS the table
        checkpoint("serve.dispatch", kind=kind)
