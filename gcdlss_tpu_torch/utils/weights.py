"""Carry weights into a port `MinkUNetSeg`, `MinkUNetRC`, `Cylinder3DRC`,
`MultiHeadCylinder3D` or library model (heads, wrappers, ORCA, mmdet3d
MinkUNet), and a JAX Stage-2 state into a port `DiscoverState`.

Counterpart of `gcdlss_tpu/utils/import_torch.py`, in pure numpy -> torch:

  * `load_jax_params`: the JAX package's `params` / `batch_stats` trees (nested
    dicts of numpy arrays) -> the port's modules. Both keep the same kernel
    layouts ([K, Ci, Co] sparse kernels, [Ci, Co] dense ones, z-fastest
    offsets, `dcode` pool order), so only the names change (`_ref_name`:
    `conv1s2` -> `conv1p1s2`, `block1/block0` -> `block1.0`, `proj` ->
    `downsample.0`, BN `scale` -> `weight`; a bottleneck's `conv1` / `conv3`
    dense and `conv2` sparse kernels keep their names; the heads `final`,
    `final2`, `final3` -> `encoder.final*`, linear (`kernel`, `bias`) or
    cosine (`weight`)). `state_dict_to_jax` is the way back. A Cylinder3D
    tree keeps its names (`cylinder_jax_to_state_dict`, and back
    `cylinder_state_dict_to_jax`), and so does a library model's but for
    its MinkUNet backbones and the mmdet3d blocks
    (`library_jax_to_state_dict`, and back `library_state_dict_to_jax`).
  * `load_jax_discover_state`: a whole JAX `DiscoverState` (student and
    teacher trees, tau, queue, step) -> a port `DiscoverState`.
  * `warm_start`: the Stage-1 -> Stage-1.5 / Stage-2 warm start from a port
    `MinkUNetSeg` state dict.
  * `load_reference_state_dict`: a reference MinkowskiEngine checkpoint
    (`encoder.*.kernel`, `*.bn.weight`, ...) -> the port, permuting kernel
    offsets from ME's order as `import_minkunet` does (`me_order`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models.layers import Linear, NormedLinear, SparseBatchNorm

_BN = (("weight", "scale", "params"), ("bias", "bias", "params"),
       ("running_mean", "mean", "batch_stats"), ("running_var", "var", "batch_stats"))
_PROJ = {"downsample.0": "proj", "downsample.1": "proj_norm"}
_PROJ_OF = {v: k for k, v in _PROJ.items()}


def offset_permutation(ksize: int, me_order: str = "first_fastest") -> np.ndarray:
    """perm[ours] = me_index so that ours_kernel = me_kernel[perm].

    Our offset order is `itertools.product(r, r, r)` (z fastest)."""
    perm = np.zeros(ksize ** 3, np.int64)
    r = range(ksize)
    for xi in r:
        for yi in r:
            for zi in r:
                o = (xi * ksize + yi) * ksize + zi
                # "last_fastest" is our own order
                perm[o] = xi + ksize * yi + ksize * ksize * zi if me_order == "first_fastest" else o
    return perm


def dcode_permutation(me_order: str = "first_fastest") -> np.ndarray:
    """perm[dcode] = me k2 index. dcode = (x<<2 | y<<1 | z)."""
    perm = np.zeros(8, np.int64)
    for x in range(2):
        for y in range(2):
            for z in range(2):
                o = (x << 2) | (y << 1) | z
                perm[o] = (x + 2 * y + 4 * z) if me_order == "first_fastest" else o
    return perm


def _ref_name(name: str) -> str:
    """Our encoder module name -> the reference's attribute (under `encoder.`)."""
    if name == "conv0p1s1" or name.startswith(("final", "bn", "block")):
        return name
    if name.startswith("convtr"):
        j = int(name[6:-2])
        return f"convtr{j}p{2 ** (8 - j)}s2"
    if name.startswith("conv") and name.endswith("s2"):
        i = int(name[4:-2])
        return f"conv{i}p{2 ** (i - 1)}s2"
    raise KeyError(f"unmapped module {name}")


def _conv_in(sd, key, shape, me_order):
    """The reference kernel `sd[key]` in our offset order, as float32."""
    w = sd[key]
    w = (w.detach().cpu().numpy() if hasattr(w, "detach") else np.asarray(w)).astype(np.float32)
    assert tuple(w.shape) == tuple(shape), (key, w.shape, shape)
    if w.ndim == 2:  # k=1 conv
        return w
    k = shape[0]
    if k == 8:
        return w[dcode_permutation(me_order)]
    ks = round(k ** (1.0 / 3.0))
    assert ks ** 3 == k, (key, k)
    return w[offset_permutation(ks, me_order)]


def jax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Port state-dict keys -> numpy arrays from JAX `params`/`batch_stats`."""
    out = {}
    _backbone_to_sd("encoder", params["encoder"], batch_stats.get("encoder", {}), out)
    for head in ("final", "final2", "final3"):
        if head in params:
            _module_to_sd(f"encoder.{head}", params[head], None, out)
    return out


def _module_to_sd(path: str, p: dict, s: dict | None, out: dict) -> None:
    """One leaf module's arrays under `path`: a batch norm's four fields, or
    its parameters as they are named."""
    if "scale" in p:  # batch norm; a gradient tree has no statistics
        for ours, theirs, tree in _BN:
            src = p if tree == "params" else (s or {})
            if theirs in src:
                out[f"{path}.{ours}"] = src[theirs]
        return
    for name, arr in p.items():
        out[f"{path}.{name}"] = arr


def _backbone_to_sd(prefix: str, enc_p: dict, enc_s: dict, out: dict) -> None:
    """A JAX `MinkUNetBackbone` tree -> the port's names under `prefix`."""
    for name, mod in enc_p.items():
        path = f"{prefix}." + _ref_name(name)
        if not name.startswith("block"):
            _module_to_sd(path, mod, enc_s.get(name), out)
            continue
        for bname, blk in mod.items():
            bpath = f"{path}.{bname.replace('block', '')}"
            bs = enc_s.get(name, {}).get(bname, {})
            for sub, sp in blk.items():
                _module_to_sd(f"{bpath}.{_PROJ_OF.get(sub, sub)}", sp, bs.get(sub), out)


def _jax_name(name: str) -> str:
    """Our encoder module name -> the JAX package's (`_ref_name` reversed)."""
    if name.startswith("conv") and name.endswith("s2"):
        return re.sub(r"p\d+s2$", "s2", name)
    return name




def state_dict_to_jax(sd: dict) -> tuple:
    """A port `MinkUNetSeg` / `MinkUNetRC` state dict (tensors or arrays) ->
    the JAX package's (`params`, `batch_stats`) trees of numpy arrays, the
    inverse of `jax_to_state_dict`."""
    groups: dict = {}
    for key, v in sd.items():
        path, field = key.rsplit(".", 1)
        groups.setdefault(path, {})[field] = np.asarray(
            v.detach().cpu() if hasattr(v, "detach") else v)
    params: dict = {}
    stats: dict = {}

    def node(tree: dict, keys: list) -> dict:
        for k in keys:
            tree = tree.setdefault(k, {})
        return tree

    for path, fields in groups.items():
        parts = path.split(".")
        if parts[0] != "encoder":
            raise KeyError(f"unmapped state-dict key {path}")
        name = parts[1]
        if name.startswith("final"):
            keys = [name]
        elif name.startswith("block"):
            sub = ".".join(parts[3:])
            keys = ["encoder", name, f"block{parts[2]}", _PROJ.get(sub, sub)]
        else:
            keys = ["encoder", _jax_name(name)]
        if "running_mean" in fields:  # batch norm
            for ours, theirs, tree in _BN:
                node(params if tree == "params" else stats, keys)[theirs] = fields[ours]
        else:
            node(params, keys).update(fields)
    return params, stats


def _is_unet_backbone(tree) -> bool:
    """A JAX `MinkUNetBackbone` (`conv0p1s1`) or `MinkUNetBackboneMM`
    (`conv_input0`) tree."""
    return isinstance(tree, dict) and ("conv0p1s1" in tree or "conv_input0" in tree)


def _tree_kind(params: dict) -> str:
    """"minkunet" (`MinkUNetSeg` / `MinkUNetRC` / `MinkUNetSegCosine`),
    "cylinder" (`Cylinder3DRC`'s `vfe`, `MultiHeadCylinder3D`'s `backbone`)
    or "library" (the heads, wrappers, ORCA and mmdet3d models)."""
    if set(params) <= {"encoder", "final", "final2", "final3"} and "conv0p1s1" in params.get(
            "encoder", {}):
        return "minkunet"
    if "vfe" in params or ("backbone" in params and not _is_unet_backbone(params["backbone"])):
        return "cylinder"
    return "library"


def cylinder_jax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Port state-dict keys -> numpy arrays from a JAX Cylinder3D tree. The
    port's modules carry the JAX names, so a path is the tree's path joined
    by dots; batch norms take `weight`/`bias`/`running_mean`/`running_var`,
    and `Cylinder3DRC`'s heads `final*` sit under `encoder.`, as
    `MinkUNetRC`'s do. Kernels keep their layouts: [K, Ci, Co] sparse ones
    in offset order (z fastest), [Ci, Co] dense ones."""
    out = {}

    def walk(path: str, p: dict, s: dict) -> None:
        if "scale" in p:  # batch norm; a gradient tree has no statistics
            for ours, theirs, tree in _BN:
                src = p if tree == "params" else s
                if theirs in src:
                    out[f"{path}.{ours}"] = src[theirs]
            return
        for name, v in p.items():
            if isinstance(v, dict):
                walk(f"{path}.{name}", v, s.get(name, {}))
            else:
                out[f"{path}.{name}"] = v

    for top, sub in params.items():
        walk(f"encoder.{top}" if top.startswith("final") else top, sub,
             batch_stats.get(top, {}))
    return out


def cylinder_state_dict_to_jax(sd: dict) -> tuple:
    """A port `Cylinder3DRC` / `MultiHeadCylinder3D` state dict -> the JAX
    package's (`params`, `batch_stats`) trees of numpy arrays, the inverse
    of `cylinder_jax_to_state_dict`."""
    params: dict = {}
    stats: dict = {}
    groups: dict = {}
    for key, v in sd.items():
        path, field = key.rsplit(".", 1)
        groups.setdefault(path, {})[field] = np.asarray(
            v.detach().cpu() if hasattr(v, "detach") else v)
    for path, fields in groups.items():
        parts = path.split(".")
        if parts[0] == "encoder" and parts[1].startswith("final"):
            parts = parts[1:]
        if "running_mean" in fields:
            trees = [(params if tree == "params" else stats, theirs, fields[ours])
                     for ours, theirs, tree in _BN]
        else:
            trees = [(params, name, v) for name, v in fields.items()]
        for tree, name, v in trees:
            for k in parts:
                tree = tree.setdefault(k, {})
            tree[name] = v
    return params, stats


def _port_parts(parts: list) -> list:
    """A JAX path below a model's top -> the port's: `*_blocks/block{j}` ->
    `*_blocks.{j}`, a block's `proj` / `proj_norm` -> `downsample.0` / `.1`."""
    out = []
    for i, p in enumerate(parts):
        if i and parts[i - 1].endswith("_blocks") and p.startswith("block"):
            out.append(p[len("block"):])
        else:
            out.extend(_PROJ_OF.get(p, p).split("."))
    return out


def _jax_parts(parts: list) -> list:
    """The inverse of `_port_parts`."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if i and parts[i - 1].endswith("_blocks") and p.isdigit():
            out.append(f"block{p}")
        elif p == "downsample":
            i += 1
            out.append(_PROJ[f"downsample.{parts[i]}"])
        else:
            out.append(p)
        i += 1
    return out


def library_jax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Port state-dict keys -> numpy arrays from the JAX tree of a library
    model (`models.heads`, `models.wrappers`, `models.orca`,
    `models.backbone_mm`). The port's modules carry the flax names
    (`head_lab.prototypes.kernel`, `head_unlab.head{h}...`, a cosine head's
    `weight`, `metric_learner.fc{i}`, `embedding`, `backbone.enc{i}_down`,
    ...), with two renames: a `MinkUNetBackbone` (`encoder`, `encoder_a`,
    `encoder_b`, `backbone`) takes the reference's module names as in
    `jax_to_state_dict`, and a block of the mmdet3d backbone is
    `dec{i}_blocks.{j}` with its projection under `downsample`."""
    out = {}

    def walk(parts: list, p: dict, s: dict) -> None:
        if "scale" in p or not any(isinstance(v, dict) for v in p.values()):
            _module_to_sd(".".join(_port_parts(parts)), p, s, out)
            return
        for name, v in p.items():
            walk(parts + [name], v, s.get(name, {}))

    for top, sub in params.items():
        if "conv0p1s1" in sub:
            _backbone_to_sd(top, sub, batch_stats.get(top, {}), out)
        else:
            walk([top], sub, batch_stats.get(top, {}))
    return out


def library_state_dict_to_jax(sd: dict) -> tuple:
    """A port library model's state dict -> the JAX package's (`params`,
    `batch_stats`) trees of numpy arrays, the inverse of
    `library_jax_to_state_dict`."""
    params: dict = {}
    stats: dict = {}
    backbones = {k.split(".")[0] for k in sd if k.split(".")[1:2] == ["conv0p1s1"]}
    groups: dict = {}
    for key, v in sd.items():
        top, rest = key.split(".", 1)
        if top in backbones:
            groups.setdefault(top, {})[f"encoder.{rest}"] = v
            continue
        path, field = key.rsplit(".", 1)
        groups.setdefault(path, {})[field] = np.asarray(
            v.detach().cpu() if hasattr(v, "detach") else v)
    for path, fields in groups.items():
        if path in backbones:
            p, s = state_dict_to_jax(fields)
            params[path], stats[path] = p["encoder"], s.get("encoder", {})
            continue
        parts = _jax_parts(path.split("."))
        if "running_mean" in fields:
            trees = [(params if tree == "params" else stats, theirs, fields[ours])
                     for ours, theirs, tree in _BN]
        else:
            trees = [(params, name, v) for name, v in fields.items()]
        for tree, name, v in trees:
            for k in parts:
                tree = tree.setdefault(k, {})
            tree[name] = v
    return params, stats


def jax_tree_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Any JAX model's trees -> port state-dict keys and numpy arrays: a
    MinkUNet's (`jax_to_state_dict`), a Cylinder3D model's or a library
    model's, told apart by their top-level names (`_tree_kind`)."""
    return {"minkunet": jax_to_state_dict, "cylinder": cylinder_jax_to_state_dict,
            "library": library_jax_to_state_dict}[_tree_kind(params)](params, batch_stats)


def state_dict_to_jax_tree(sd: dict) -> tuple:
    """The inverse of `jax_tree_to_state_dict`, told apart by the keys: a
    MinkUNet's state dict holds only `encoder.*`, the reference's stem
    `encoder.conv0p1s1` among them; a Cylinder3D model's a `vfe` or a
    backbone without a UNet stem."""
    tops = {k.split(".")[0] for k in sd}
    if tops == {"encoder"} and "encoder.conv0p1s1.kernel" in sd:
        return state_dict_to_jax(sd)
    if "vfe" in tops or ("backbone" in tops and not any(
            k.startswith(("backbone.conv0p1s1.", "backbone.conv_input0.")) for k in sd)):
        return cylinder_state_dict_to_jax(sd)
    return library_state_dict_to_jax(sd)


def load_jax_params(model: torch.nn.Module, params: dict, batch_stats: dict) -> None:
    """Load the JAX package's trees into `model` (every tensor must match):
    a MinkUNet's, a Cylinder3D model's or a library model's."""
    sd = {k: torch.as_tensor(np.array(v, np.float32))
          for k, v in jax_tree_to_state_dict(params, batch_stats).items()}
    model.load_state_dict(sd, strict=True)


def load_jax_discover_state(state, tree: dict) -> None:
    """Load a JAX `DiscoverState` given as numpy trees (`params_s`,
    `batch_stats_s`, `params_t`, `batch_stats_t`, `tau`, `queue` as its
    (feats, counts, head) triple, `step`) into a port `DiscoverState` in
    place. The SGD momentum buffers are not carried: they start empty, as
    at step 0."""
    from ..algo.queue import FeatureQueue

    load_jax_params(state.student, tree["params_s"], tree["batch_stats_s"])
    load_jax_params(state.teacher, tree["params_t"], tree["batch_stats_t"])
    dev = state.tau.device
    with torch.no_grad():
        state.tau.copy_(torch.as_tensor(np.asarray(tree["tau"], np.float32)))
    state.queue = FeatureQueue(*(torch.as_tensor(np.asarray(a), device=dev)
                                 for a in tree["queue"]))
    state.step = int(tree["step"])


def warm_start(model: torch.nn.Module, pretrained: dict) -> list:
    """Stage-1 -> Stage-1.5 / Stage-2 warm start: copy the parameters of a
    port `MinkUNetSeg` state dict (the backbone and `encoder.final`) into a
    `MinkUNetRC`, as the JAX package's `create_finetune_state` and
    `create_discover_state` copy the `encoder` and `final` trees. Batch-norm statistics and the heads the
    dict lacks (`final2`, `final3`) stay as they are. Returns the names of
    the parameters left as they were."""
    params = dict(model.named_parameters())
    new = {k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                                         np.float32))
           for k, v in pretrained.items() if k in params}
    model.load_state_dict(new, strict=False)
    return sorted(set(params) - set(new))


def load_reference_state_dict(model: torch.nn.Module, sd: dict, prefix: str = "",
                              me_order: str = "first_fastest") -> list:
    """Load a reference-layout state dict (numpy arrays or CPU tensors).

    Kernel offsets are permuted from ME's order (`me_order`, see
    `offset_permutation`). Tensors the dict
    lacks (e.g. heads a Stage-1 checkpoint has no use for) keep their values,
    like the reference's strict=False load; their names are returned."""
    new, missing = {}, []

    def take(ours: str, key: str, value_fn):
        if key in sd:
            new[ours] = torch.as_tensor(np.array(value_fn(key), np.float32))
        else:
            missing.append(ours)

    def raw(key):
        v = sd[key]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else v

    for name, mod in model.named_modules():
        ref = prefix + name
        if isinstance(mod, SparseBatchNorm):
            for field in ("weight", "bias", "running_mean", "running_var"):
                take(f"{name}.{field}", f"{ref}.bn.{field}", raw)
        elif hasattr(mod, "kernel"):
            shape = tuple(mod.kernel.shape)
            take(f"{name}.kernel", f"{ref}.kernel",
                 lambda key: _conv_in({key: raw(key)}, key, shape, me_order))
            if isinstance(mod, Linear) and mod.bias is not None:
                take(f"{name}.bias", f"{ref}.bias", raw)
        elif isinstance(mod, NormedLinear):  # cosine head: `weight` [Ci, features]
            take(f"{name}.weight", f"{ref}.weight", raw)
    model.load_state_dict(new, strict=False)
    return missing
