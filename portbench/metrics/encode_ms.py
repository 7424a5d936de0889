"""The program's encode seconds (``stats["encode_s"]``), summed over a
round's problems, mean per round, in ms."""


def read(run):
    rounds = [r for r in run.rounds if r.stats]
    if not rounds:
        return None
    return sum(sum(s.get("encode_s", 0.0) for s in r.stats) for r in rounds) / len(rounds) * 1e3
