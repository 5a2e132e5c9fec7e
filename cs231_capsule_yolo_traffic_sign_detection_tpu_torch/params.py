"""Experiment hyper-parameter container (PyTorch port).

A copy of the JAX package's jax-free ``params.py``: the same
JSON-per-experiment schema (``experiments/<model>/params.json``),
merged with the command-line overrides.
"""

import json


class Params:
    """Loads hyperparameters from a JSON file into attributes."""

    def __init__(self, json_path=None, **kwargs):
        if json_path is not None:
            with open(json_path) as f:
                self.__dict__.update(json.load(f))
        self.__dict__.update(kwargs)

    def save(self, json_path):
        with open(json_path, "w") as f:
            json.dump(self._jsonable(), f, indent=4)

    def _jsonable(self):
        out = {}
        for k, v in self.__dict__.items():
            try:
                json.dumps(v)
                out[k] = v
            except TypeError:
                pass  # skip non-serializable runtime attachments
        return out

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def __repr__(self):
        return "Params(" + ", ".join(
            f"{k}={v!r}" for k, v in sorted(self._jsonable().items())
        ) + ")"
