"""KiB the solvers' stagers moved to the card (``DeviceStager.stats
["bytes_transferred"]``), summed over the round's solvers, mean per round."""


def read(run):
    return sum(r.staged for r in run.rounds) / len(run.rounds) / 1024.0
