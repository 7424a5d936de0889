"""Traffic generators: ``generators/<name>.py`` plays the rounds of every
``traffic/<mix>.json`` whose ``generator`` key names it."""
