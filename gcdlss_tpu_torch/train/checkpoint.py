"""Checkpoints, resume and the Stage-1 handoff on `torch.save` / `torch.load`
(PyTorch port of `gcdlss_tpu/train/checkpoint.py`, which uses orbax).

A checkpoint holds everything a resumed run needs to draw and update exactly
as an unbroken one: for a `TrainState` the model's parameters and batch-norm
buffers, the SGD momentum buffers and the step; for a `DiscoverState` also
the teacher, tau, the feature queue and the step generator's state. It is
written as nested dicts of CPU tensors and plain numbers (a generator's
state is its `uint8` tensor), so a card's checkpoint loads on the CPU and
`torch.load(weights_only=True)` reads it: no class is pickled.

`CheckpointManager` keeps one directory per step, `<directory>/<step>/`,
written to a temporary name and renamed into place. `save_pretrained` writes
a model's state dict under `<directory>/pretrained/`, the layout
`utils.weights.warm_start` reads.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch
from torch import nn

_STATE_FILE = "state.pt"


def _cpu(tree):
    """`tree` with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _pack(value):
    if isinstance(value, nn.Module):
        return {"module": _cpu(value.state_dict())}
    if isinstance(value, torch.optim.Optimizer):
        return {"optimizer": _cpu(value.state_dict())}
    if isinstance(value, torch.Generator):
        return {"generator": value.get_state()}
    if isinstance(value, torch.Tensor):
        return {"tensor": _cpu(value)}
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # e.g. FeatureQueue
        return {"fields": {k: _pack(v) for k, v in zip(value._fields, value)}}
    if value is None or isinstance(value, (bool, int, float, str)):
        return {"value": value}
    raise TypeError(f"cannot checkpoint a {type(value).__name__}")


def _unpack(packed: dict, template):
    """The value of `packed`, restored into (or shaped like) `template`."""
    (kind, data), = packed.items()
    if kind == "module":
        template.load_state_dict(data, strict=True)
        return template
    if kind == "optimizer":
        template.load_state_dict(data)
        return template
    if kind == "generator":
        template.set_state(data)
        return template
    if kind == "tensor":
        with torch.no_grad():
            template.copy_(data)
        return template
    if kind == "fields":
        return type(template)(**{k: _unpack(data[k], getattr(template, k))
                                 for k in template._fields})
    if kind == "value":
        return data
    raise ValueError(f"unknown checkpoint entry {kind!r}")


def state_to_dict(state) -> dict:
    """A training state dataclass (`TrainState`, `DiscoverState`) as nested
    dicts of CPU tensors and plain values, one entry per field."""
    return {f.name: _pack(getattr(state, f.name)) for f in dataclasses.fields(state)}


def load_state_dict_into(state, tree: dict):
    """Restore `tree` (`state_to_dict`'s output) into `state` in place: the
    modules, optimizer, tau and generator keep their objects and devices; the
    queue's tensors are copied into its own; the step is set. Every field of
    the state must be in the tree, and no other. Returns `state`."""
    names = [f.name for f in dataclasses.fields(state)]
    if sorted(names) != sorted(tree):
        raise KeyError(f"checkpoint fields {sorted(tree)} do not match the state's {sorted(names)}")
    for name in names:
        setattr(state, name, _unpack(tree[name], getattr(state, name)))
    return state


class CheckpointManager:
    """Per-step checkpoints under `directory` (`<directory>/<step>/state.pt`).

    `save(step, state)` writes when `step` is a multiple of
    `save_interval_steps` and keeps the newest `max_to_keep` steps (all when
    None); `restore(state, step=None)` loads a step (the latest by default)
    into `state` in place and returns it, or None when there is none."""

    def __init__(self, directory: str, max_to_keep: int | None = None,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(self._file(int(n))))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _file(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _STATE_FILE)

    def save(self, step: int, state) -> bool:
        step = int(step)
        if step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state_to_dict(state), os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state, step: int | None = None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(self._file(step), map_location="cpu", weights_only=True)
        return load_state_dict_into(state, tree)


def save_pretrained(directory: str, state_dict: dict) -> None:
    """Save a model's state dict (CPU tensors) as the Stage-1 -> Stage-1.5 /
    Stage-2 handoff artifact, `<directory>/pretrained/state_dict.pt`; a
    repeated save replaces it."""
    out = os.path.join(os.path.abspath(directory), "pretrained")
    os.makedirs(out, exist_ok=True)
    torch.save(_cpu(dict(state_dict)), os.path.join(out, "state_dict.pt"))


def load_pretrained(directory: str) -> dict:
    """The state dict `save_pretrained` wrote under `directory` (CPU
    tensors), for `utils.weights.warm_start`."""
    path = os.path.join(os.path.abspath(directory), "pretrained", "state_dict.pt")
    return torch.load(path, map_location="cpu", weights_only=True)
