"""Configuration builders: ``builders/<name>.py`` makes a configuration's raw
inputs and the program's objects, and checks a plan, for every
``configs/<config>.json`` whose ``builder`` key names it."""
