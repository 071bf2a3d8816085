"""Training metrics: a results dict dumped to CSVs, ``results.json`` and a
``performance.png`` plot, with optional TensorBoard scalars (counterpart
of the JAX package's ``utils/logging.py``).

TensorBoard and matplotlib are optional and imported only when used:
without tensorboard a requested writer prints why and the run logs to the
files alone; without matplotlib the plot is skipped with a printed line.
"""

import json
import os
from collections import defaultdict

import numpy as np


class ResultsLogger:
    _CSV_KEYS = (
        "mean_success", "std_success", "loss", "mean_divergence_full",
        "std_divergence_full", "mean_divergence", "std_divergence",
    )

    def __init__(self, save_path, tensorboard=False):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self.results = defaultdict(list)
        # the reference's offset, so losses and evals align
        self.results["loss"].append(0)
        self._tb = None
        self._tb_steps = defaultdict(int)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(save_path)
            except Exception as exc:
                print(
                    "tensorboard requested but unavailable "
                    f"({exc!r}); falling back to CSV/JSON logging"
                )

    def log(self, key, value):
        self.results[key].append(
            float(value) if np.isscalar(value) or hasattr(value, "item")
            else value
        )
        if self._tb is not None and np.isscalar(self.results[key][-1]):
            # a step counter per key: the loss sentinel above aligns the
            # results lists and must not shift the TensorBoard steps
            self._tb.add_scalar(key, self.results[key][-1],
                                self._tb_steps[key])
            self._tb_steps[key] += 1

    def log_dict(self, d):
        for k, v in d.items():
            self.log(k, v)

    def finalize(self, plot=True):
        """Write the CSVs, ``results.json`` and (``plot``) the performance
        plot; flush TensorBoard."""
        for key in self._CSV_KEYS:
            if self.results.get(key):
                np.savetxt(
                    os.path.join(self.save_path, f"{key}.csv"),
                    np.asarray(self.results[key], dtype=float),
                    delimiter=",",
                )
        with open(os.path.join(self.save_path, "results.json"), "w") as f:
            json.dump(dict(self.results), f, default=float)
        if plot:
            try:
                self._plot()
            except Exception as exc:  # matplotlib missing or headless
                print(f"performance plot skipped: {exc}")
        if self._tb is not None:
            self._tb.flush()

    def _plot(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        if self.results.get("loss"):
            axes[0].plot(self.results["loss"])
            axes[0].set_title("loss")
        if self.results.get("mean_success"):
            m = np.asarray(self.results["mean_success"], dtype=float)
            s = np.asarray(
                self.results.get("std_success", np.zeros_like(m)),
                dtype=float,
            )
            axes[1].plot(m)
            if len(s) == len(m):
                axes[1].fill_between(np.arange(len(m)), m - s, m + s,
                                     alpha=0.3)
            axes[1].set_title("success")
        fig.tight_layout()
        fig.savefig(os.path.join(self.save_path, "performance.png"))
        plt.close(fig)
