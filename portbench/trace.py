"""The traced run's device timeline: a ``torch.profiler`` trace of the
window's first rounds, read into the card's busy time within the rounds,
the kernels' device seconds by name, and the idle time by the harness span
the host was in."""

from __future__ import annotations


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged, a, b) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


class Profiler:
    """Profiles the card and the host's ranges from ``start()`` to
    ``stop()``; ``summary`` holds what the metrics read."""

    def __init__(self):
        self.prof = None
        self.running = False
        self.summary = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.running = True

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.running = False
        self.summary = summarize(self.prof.events())
        self.prof = None


def summarize(events) -> dict:
    """Busy seconds of the card inside the traced rounds, their length,
    device seconds and launches by kernel name (all of the trace), each
    round's launches, and the breakdown: the device operations that took
    most time and the idle seconds by the harness span they fall in."""
    device, ranges = [], {}
    for ev in events:
        a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name.startswith("portbench.") and str(ev.device_type).endswith("CUDA"):
            continue  # the harness's ranges, mirrored on the device's timeline
        if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False):
            device.append((ev.name, a, b))
        elif ev.name.startswith("portbench."):
            ranges.setdefault(ev.name[len("portbench."):], []).append((a, b))
    rounds = sorted(ranges.pop("round", []))
    busy = _union([(a, b) for _, a, b in device])
    window = sum(b - a for a, b in rounds)
    busy_s = sum(_overlap(busy, a, b) for a, b in rounds)
    kernel_s, launches = {}, {}
    per_round = [dict() for _ in rounds]
    for name, a, b in device:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a)
        launches[name] = launches.get(name, 0) + 1
        for i, (x, y) in enumerate(rounds):
            if x <= a <= y:
                per_round[i][name] = per_round[i].get(name, 0) + 1
                break
    idle = {}
    labelled = _union([span for spans in ranges.values() for span in spans])
    for x, y in rounds:
        gaps = [(max(a, x), min(b, y)) for a, b in _complement(busy, x, y)]
        for label, spans in ranges.items():
            for a, b in spans:
                if b < x or a > y:
                    continue
                idle[label] = idle.get(label, 0.0) + sum(
                    max(0.0, min(b, q) - max(a, p)) for p, q in gaps)
        covered = sum(_overlap(labelled, p, q) for p, q in gaps)
        idle["other"] = idle.get("other", 0.0) + sum(q - p for p, q in gaps) - covered
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((k, v) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window, "rounds": len(rounds),
            "kernel_s": kernel_s, "launches": launches, "per_round": per_round,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in gaps]}}


def _complement(merged, x, y):
    """The parts of [x, y] that no merged interval covers."""
    out, at = [], x
    for a, b in merged:
        if b <= at:
            continue
        if a >= y:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < y:
        out.append((at, y))
    return out
