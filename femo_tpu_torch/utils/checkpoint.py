"""Optimization checkpoint and resume (port of femo_tpu/utils/
checkpoint.py).

Design variables, state warm starts, the optimizer's iteration counter
and the objective history go to one .npz under the same keys as the JAX
package's (`value/<name>`, `state/<name>`, `opt_iter`, `history/obj`,
`extra/<name>`), so either package reads a checkpoint the other wrote.
Tensors are copied to the host to save and restored onto the model's
device in the working dtype.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import config


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, sim, problem=None, extra: dict | None = None):
    """Snapshot Simulator values (and state warm starts) to .npz."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {f"value/{k}": _host(v) for k, v in sim.values.items()}
    model = sim.model
    for fea in getattr(model, "fea_list", []):
        for sname, s in fea.states_dict.items():
            payload[f"state/{sname}"] = _host(s["function"].array)
        payload["opt_iter"] = np.asarray(fea.opt_iter)
    if problem is not None:
        payload["history/obj"] = np.asarray(
            [h["obj"] for h in problem.history])
    for k, v in (extra or {}).items():
        payload[f"extra/{k}"] = _host(v)
    np.savez(path, **payload)


def load_checkpoint(path: str, sim, problem=None) -> dict:
    """Restore a snapshot into a Simulator; returns the extras dict."""
    data = np.load(path)
    extras = {}
    model = sim.model

    def dev(a, device):
        return torch.as_tensor(np.asarray(a), dtype=config.dtype,
                               device=device)

    for key in data.files:
        kind, _, name = key.partition("/")
        if kind == "value":
            sim.values[name] = dev(data[key], model.device)
        elif kind == "state":
            for fea in getattr(model, "fea_list", []):
                if name in fea.states_dict:
                    f = fea.states_dict[name]["function"]
                    f.array = dev(data[key], f.space.device)
        elif kind == "history" and problem is not None:
            problem.history = [
                {"obj": float(v), "time": 0.0} for v in data[key]]
        elif kind == "extra":
            extras[name] = data[key]
        elif key == "opt_iter":
            for fea in getattr(model, "fea_list", []):
                fea.opt_iter = int(data[key])
    return extras
