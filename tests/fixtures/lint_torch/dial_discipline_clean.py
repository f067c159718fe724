"""Clean twin for the dial-discipline rule: probes and one-shot admin
ops keep the one-shot API (a fresh connection is the POINT there), and
hot paths dispatch over the pooled channels.  Nothing here may be
flagged."""

from csmom_tpu_torch.serve import proto

_POOL = proto.ChannelPool()


def probe_worker(worker):
    # a probe measures the peer's ability to ACCEPT — one-shot is right
    return proto.request_once(worker.socket_path, {"op": "ping"},
                              timeout_s=2.0)


def collect_stats(handles):
    out = []
    for h in handles:
        obj, _ = proto.request(h.socket_path, {"op": "stats"},
                               timeout_s=5.0)
        out.append(obj)
    return out


def drain_stop(handle):
    return proto.request_once(handle.socket_path, {"op": "stop"},
                              timeout_s=10.0)


def _attempt(worker, header, values, mask, timeout):
    # the hot path on the pooled multiplexed transport
    return _POOL.request(worker.socket_path, header,
                         arrays={"values": values, "mask": mask},
                         timeout_s=timeout)
