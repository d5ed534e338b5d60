"""Unified typed configuration (PyTorch port of `gcdlss_tpu/config.py`).

`ExperimentConfig` holds the command line's and a dataset file's fields
under the same names; `load_config` merges a file under the keyword
overrides. The files under `gcdlss_tpu_torch/configs/` are copies of the
JAX package's, held to them by a test. They are flat `key: value` files,
read by `read_flat_yaml` with the scalar types `yaml.safe_load` gives them,
so the port needs no YAML library.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from pathlib import Path

from .data.labels import build_label_mapping, split_table
from .data.meta import dataset_meta
from .train.common import default_caps

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


@dataclass
class ExperimentConfig:
    # dataset
    dataset: str = "SemanticKITTI"
    dataset_path: str = ""
    split: int = 1
    voxel_size: float = 0.05
    downsampling: int = 80000
    batch_size: int = 4
    num_workers: int = 8
    loader_backend: str = "thread"  # or "process" (worker processes, GIL-free)
    # capacities (static shapes); 0 -> derived from downsampling * batch
    voxel_cap: int = 0
    point_cap: int = 0
    # model
    arch: str = "MinkUNet34"
    # optimizer
    train_lr: float = 1e-2
    finetune_lr: float = 1e-4
    momentum_for_optim: float = 0.9
    weight_decay_for_optim: float = 1e-4
    use_scheduler: bool = False
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    # run
    module: str = "ExpPretrain"
    experiment: str = "exp"
    log_dir: str = "logs"
    checkpoint_dir: str = "checkpoints"
    pretrained: str | None = None
    resume_checkpoint: str | None = None
    checkpoint: str | None = None
    seed: int = 1234
    debug: bool = False
    test: bool = False
    visualize: bool = False
    split_dir: str = "split_npy"

    def resolved_caps(self):
        per_scan = self.downsampling if self.downsampling > 0 else 120_000
        cap0 = self.voxel_cap or -(-(per_scan * self.batch_size) // 2048) * 2048
        return default_caps(cap0)

    def label_space(self):
        meta = dataset_meta(self.dataset)
        unknown_labels, ratio = split_table(self.dataset, self.split)
        mapping, inv, unknown_label = build_label_mapping(
            unknown_labels, meta["learning_map_inv"].keys())
        return {
            "meta": meta,
            "unknown_labels": unknown_labels,
            "labeled_ratio": ratio,
            "label_mapping": mapping,
            "label_mapping_inv": inv,
            "unknown_label": unknown_label,
            "num_classes": len(mapping),
            "num_unlabeled_classes": len(unknown_labels),
            "num_labeled_classes": len(mapping) - len(unknown_labels),
        }


# the plain scalars of YAML 1.1 as PyYAML's resolver reads them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                  "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
# other ints YAML 1.1 knows (octal, hex, binary, base 60) and the starts of
# what is no plain scalar: this reader refuses them
_REFUSED = re.compile(r"^(?:[-+]?0[0-7_]+|[-+]?0[xb].*|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+.*"
                      r"|[\[\]{}&*!|>%@`].*|- .*|-)$")


def _scalar(text: str, where: str):
    if _REFUSED.match(text):
        raise ValueError(f"{where}: {text!r} is no flat scalar this reader takes")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    return text


def _value(raw: str, where: str):
    """The scalar of a line's value part (after `key:`), its comment cut."""
    raw = raw.strip()
    if raw[:1] in ("'", '"'):
        q = raw[0]
        close = raw.find(q, 1)
        rest = raw[close + 1:] if close > 0 else ""
        if close < 0 or (rest and not re.match(r"^\s+#", rest)) or "\\" in raw[1:close]:
            raise ValueError(f"{where}: cannot read the quoted scalar {raw!r}")
        return raw[1:close]
    return _scalar(re.sub(r"(^|\s)#.*$", "", raw).rstrip(), where)


def read_flat_yaml(path) -> dict:
    """A flat `key: value` YAML file as `yaml.safe_load` reads it: comments
    (a `#` at a line's start or after a blank) and blank lines skipped, each
    value a null, bool, int, float or string, plain or quoted. Raises
    ValueError on anything else: an indented line (nesting), a list item, a
    flow collection, an anchor, a tag, a block scalar, an escape in a quoted
    string, a line that is no `key: value`."""
    out: dict = {}
    with open(path) as f:
        for no, line in enumerate(f, 1):
            where = f"{path}:{no}"
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if line[0] in " \t":
                raise ValueError(f"{where}: indented line (nesting is not read): {line!r}")
            m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*):(\s.*|)$", line)
            if not m:
                raise ValueError(f"{where}: not a flat `key: value` line: {line!r}")
            out[m.group(1)] = _value(m.group(2), where)
    return out


def load_config(path: str | None = None, **overrides) -> ExperimentConfig:
    data: dict = {}
    if path:
        data = read_flat_yaml(path)
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    merged = {k: v for k, v in {**data, **overrides}.items() if k in known}
    return ExperimentConfig(**merged)
