"""Kernels' shares of their roofline from the traced rounds: the least time
the card could take for the chains' work, counted from each problem's shapes
(``counts.chain_least_s``), over the device time of the named kernels."""

from . import counts

K2 = ("k2_prices", "k2_scan")
CHAIN = ("k1_units", "k1_val_pair", "k2_prices", "k2_scan", "k3_pack_epilogue",
         "k_stage_patch", "k_fleet_stack")


def share(run, which: int, names) -> float:
    t = run.trace
    if not t:
        return None
    least = 0.0
    for r, launches in zip(run.rounds, t["per_round"]):
        if any("k3_pack_epilogue" in name for name in launches):
            least += sum(counts.chain_least_s(G, O, 0, 3, S)[which] for G, O, S in r.shapes)
    spent = sum(s for name, s in t["kernel_s"].items() if any(k in name for k in names))
    return 100.0 * least / spent if spent > 0 and least > 0 else None
