"""Training metrics: a results dict dumped to CSVs and ``results.json``
(counterpart of the JAX package's ``utils/logging.py``, without
TensorBoard and without the plot)."""

import json
import os
from collections import defaultdict

import numpy as np


class ResultsLogger:
    _CSV_KEYS = (
        "mean_success", "std_success", "loss", "mean_divergence_full",
        "std_divergence_full", "mean_divergence", "std_divergence",
    )

    def __init__(self, save_path):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self.results = defaultdict(list)
        # the reference's offset, so losses and evals align
        self.results["loss"].append(0)

    def log(self, key, value):
        self.results[key].append(
            float(value) if np.isscalar(value) or hasattr(value, "item")
            else value
        )

    def log_dict(self, d):
        for k, v in d.items():
            self.log(k, v)

    def finalize(self):
        for key in self._CSV_KEYS:
            if self.results.get(key):
                np.savetxt(
                    os.path.join(self.save_path, f"{key}.csv"),
                    np.asarray(self.results[key], dtype=float),
                    delimiter=",",
                )
        with open(os.path.join(self.save_path, "results.json"), "w") as f:
            json.dump(dict(self.results), f, default=float)
