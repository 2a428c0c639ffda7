"""Traffic: each mix is a data file ``<traffic>.json`` whose ``kind``
names the general generator that reads it (``<kind>.py``)."""

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_mix(name):
    """The mix's parameters (``<name>.json``)."""
    return json.loads((HERE / f"{name}.json").read_text())


def generator(kind):
    """The generator module of a traffic kind."""
    return importlib.import_module(f"{__name__}.{kind}")
