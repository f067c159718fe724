"""Known-bad fixture for the dial-discipline rule: one-shot dials on
request hot paths: a connection per request, where the pooled
transport keeps persistent channels.  Every call here must be flagged."""

from csmom_tpu_torch.serve import proto
from csmom_tpu_torch.serve.proto import request_once as one_shot


def _attempt(worker, header, values, mask, timeout):
    # a dispatch attempt dialing per call
    return proto.request(worker.socket_path, header,
                         arrays={"values": values, "mask": mask},
                         timeout_s=timeout)


def drive_request(router, header, arrays):
    # the fabric client's hot path on the one-shot API (aliased import)
    return one_shot(router.socket_path, header, arrays, timeout_s=5.0)


def dispatch_loop(workers, header, arrays):
    out = []
    for w in workers:
        obj, _ = proto.request_once(w.socket_path, header, arrays)
        out.append(obj)
    return out
