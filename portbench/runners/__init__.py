"""Runners: how a cell drives the program. A cell's file names one
(``"runner"``); each module has ``run(ctx) → harness.Run``."""
