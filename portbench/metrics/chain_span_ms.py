"""The program's CUDA events around the chain (``stats
["dispatch_device_ms"]``), mean per problem that reported one, in ms."""


def read(run):
    xs = [s["dispatch_device_ms"] for r in run.rounds for s in r.stats
          if s.get("dispatch_device_ms") is not None]
    return sum(xs) / len(xs) if xs else None
