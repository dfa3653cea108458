"""Parameter bridges into the port's ``state_dict`` layout, and seeded init.

``raft_state_from_jax`` / ``i3d_state_from_jax`` / ``pwc_state_from_jax`` /
``r21d_state_from_jax`` / ``s3d_state_from_jax`` / ``resnet_state_from_jax``
/ ``clip_state_from_jax`` / ``vggish_state_from_jax`` map a JAX parameter
tree (nested dicts of numpy arrays, as
``video_features_tpu.models.*.init_params`` or ``params_from_torch`` build
them) onto the port's modules, whose names are the reference checkpoints'
keys. They invert the JAX ``params_from_torch``:

  - conv kernels HWIO -> OIHW, 3D kernels DHWIO -> OIDHW, dense kernels
    (in, out) -> (out, in);
  - BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``
    (plus ``num_batches_tracked``, which the JAX tree drops);
  - Sequential indices come back out of the flat names (``layer1_0`` ->
    ``layer1.0``, ``branch_1_0`` -> ``branch_1.0``; R(2+1)D's and S3D's
    named submodules go back to torchvision's and the reference's
    Sequential indices), RAFT's ``update_mask``
    returns under ``update_block.mask``, and a batch-norm RAFT block's
    ``downsample.1`` is written under ``norm3`` too (the reference registers
    that module twice).

CLIP's transformer blocks hold separate ``q_proj``/``k_proj``/``v_proj`` in
the JAX tree; the port (and the reference) packs them into
``attn.in_proj_weight`` (3E, E) and ``in_proj_bias``. ``AttentionPool2d``
keeps them separate in both. A LayerNorm's ``ln/scale`` is its ``weight``.

PWC's transposed convolutions (``moduleUpflow`` / ``moduleUpfeat``) are raw
params in the JAX tree, stored as the spatially flipped HWIO kernel of the
input-dilated convolution they become (``params_from_torch`` builds them from
torch's IOHW ``ConvTranspose2d`` weight); the inverse is
``transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]``, not the generic HWIO ->
OIHW.

RAFT's ``convc1`` kernel ``(1, 1, 324, 256)`` has its rows in the lookup's
channel order (per level, tap ``k = xx * 9 + yy``, x-offset slowest); that is
the order of the port's lookup too, so it transposes like any 1x1 conv.

``seeded_init_`` is the port's own random init for
``allow_random_weights=true`` (LeCun-normal kernels from a seeded
``torch.Generator``, zero biases, identity batch norms); it needs no flax.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _kernel_to_torch(k: np.ndarray) -> torch.Tensor:
    """HWIO / DHWIO -> OIHW / OIDHW."""
    k = np.asarray(k, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(k, (-1, -2), (0, 1))))


def _bn_modules(params: Mapping[str, Any]) -> set:
    return {path.rsplit("/", 1)[0] for path in _flatten(params)
            if path.endswith("/mean")}


def _to_state(params: Mapping[str, Any], module_key) -> Dict[str, torch.Tensor]:
    """Common walk: ``module_key(jax_module_path) -> torch module key``."""
    flat = _flatten(params)
    bn = _bn_modules(params)
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        mod_path, leaf = path.rsplit("/", 1)
        key = module_key(mod_path)
        if mod_path in bn:
            state[f"{key}.{_BN_LEAF[leaf]}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
        elif leaf == "kernel":
            state[f"{key}.weight"] = _kernel_to_torch(value)
        else:
            state[f"{key}.{leaf}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    for mod_path in bn:
        state[f"{module_key(mod_path)}.num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return state


_SEQ = re.compile(r"^(layer\d+|downsample|mask)_(\d+)$")


def _raft_key(mod_path: str) -> str:
    parts = mod_path.split("/")
    if parts[0] == "update_mask":  # the mask head lives in update_block
        parts = ["update_block"] + parts[1:]
    out = []
    for p in parts:
        m = _SEQ.match(p)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    return ".".join(out)


def raft_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RAFT tree -> the port's (and the reference's) RAFT state dict."""
    state = _to_state(params, _raft_key)
    for key in list(state):
        if ".downsample.1." in key:  # the reference's norm3 alias
            state[key.replace(".downsample.1.", ".norm3.")] = state[key]
    return state


def _i3d_key(mod_path: str) -> str:
    parts = mod_path.split("/")
    leaf = parts[-1]
    block = parts[:-1]
    # branch_1_0 -> branch_1.0; branch_0 stays
    block = [re.sub(r"^(branch_\d)_(\d)$", r"\1.\2", p) for p in block]
    return ".".join(block + [{"conv": "conv3d", "bn": "batch3d"}[leaf]])


def i3d_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX I3D tree -> the port's (and the reference's) I3D state dict."""
    return _to_state(params, _i3d_key)


_PWC_SEQ = re.compile(r"^(module[A-Za-z]+)_(\d+)$")
_PWC_UPCONV = re.compile(r"^(moduleUp(?:flow|feat))_(kernel|bias)$")


def _pwc_key(mod_path: str) -> str:
    return ".".join(_PWC_SEQ.sub(r"\1.\2", p) for p in mod_path.split("/"))


def pwc_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PWC tree -> the port's (and the reference's) PWC state dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        mod_path, leaf = path.rsplit("/", 1)
        key = _pwc_key(mod_path)
        arr = np.asarray(value, dtype=np.float32)
        up = _PWC_UPCONV.match(leaf)
        if up and up.group(2) == "kernel":  # flipped HWIO -> IOHW
            state[f"{key}.{up.group(1)}.weight"] = torch.from_numpy(
                np.ascontiguousarray(
                    np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]))
        elif up:
            state[f"{key}.{up.group(1)}.bias"] = torch.from_numpy(arr.copy())
        elif leaf == "kernel":
            state[f"{key}.weight"] = _kernel_to_torch(arr)
        else:
            state[f"{key}.{leaf}"] = torch.from_numpy(arr.copy())
    return state


#: R(2+1)D: JAX submodule -> torchvision ``VideoResNet`` Sequential path
_R21D_STEM = {"stem_conv_s": "stem.0", "stem_bn_s": "stem.1",
              "stem_conv_t": "stem.3", "stem_bn_t": "stem.4"}
_R21D_BLOCK = {"conv1/conv_s": "conv1.0.0", "conv1/bn_mid": "conv1.0.1",
               "conv1/conv_t": "conv1.0.3", "bn1": "conv1.1",
               "conv2/conv_s": "conv2.0.0", "conv2/bn_mid": "conv2.0.1",
               "conv2/conv_t": "conv2.0.3", "bn2": "conv2.1",
               "downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}


def _r21d_key(mod_path: str) -> str:
    if "/" not in mod_path:  # the stem's modules, or the head's fc
        return _R21D_STEM.get(mod_path, mod_path)
    block, sub = mod_path.split("/", 1)
    return block.replace("_", ".") + "." + _R21D_BLOCK[sub]


def r21d_state_from_jax(params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX R(2+1)D ``{'backbone', 'head'}`` trees -> the port's (and
    torchvision's) ``R2Plus1D`` state dict, ``fc`` included."""
    return _to_state({**params["backbone"], **params["head"]}, _r21d_key)


#: S3D: JAX block name -> index in the reference's ``base`` Sequential
_S3D_BASE = {"stem_sep1": "0", "stem_basic": "2", "stem_sep2": "3",
             "m3b": "5", "m3c": "6", "m4b": "8", "m4c": "9", "m4d": "10",
             "m4e": "11", "m4f": "12", "m5b": "14", "m5c": "15"}


def _s3d_key(mod_path: str) -> str:
    if mod_path == "fc":
        return "fc.0"
    block, *rest = mod_path.split("/")
    rest = [re.sub(r"^(branch\d)_(\d)$", r"\1.\2", p) for p in rest]
    return ".".join(["base", _S3D_BASE[block]] + rest)


def s3d_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX S3D tree (classifier ``fc`` included) -> the port's (and the
    reference's) S3D state dict."""
    return _to_state(params, _s3d_key)


def _resnet_key(mod_path: str) -> str:
    block, _, sub = mod_path.partition("/")
    sub = {"downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}.get(sub, sub)
    return ".".join(p for p in (block.replace("_", "."), sub) if p)


def resnet_state_from_jax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX ResNet ``{'backbone', 'head'}`` trees -> the port's (and
    torchvision's) ``ResNet`` state dict, ``fc`` included."""
    return _to_state({**params["backbone"], **params["head"]}, _resnet_key)


_CLIP_SEQ = re.compile(r"^(resblocks|layer\d|downsample)_(-?\d+)$")
#: raw (module-less) CLIP parameters, copied as they are
_CLIP_RAW = ("class_embedding", "positional_embedding", "proj",
             "text_projection", "logit_scale")


def _clip_key(mods) -> str:
    out = []
    for m in mods:
        seq = _CLIP_SEQ.match(m)
        if seq:
            out.append(f"{seq.group(1)}.{seq.group(2)}")
        elif m.startswith("mlp_"):
            out.append("mlp." + m[len("mlp_"):])
        else:
            out.append(m)
    return ".".join(out)


def clip_state_from_jax(params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX CLIP tree (ViT or ModifiedResNet) -> the port's (and the
    reference's) CLIP state dict."""
    bn = _bn_modules(params)
    state: Dict[str, torch.Tensor] = {}
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    for path, value in _flatten(params).items():
        *mods, leaf = path.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "attnpool_positional_embedding":
            key = _clip_key(mods + ["attnpool", "positional_embedding"])
        elif leaf == "token_embedding":
            key = "token_embedding.weight"
        elif leaf in _CLIP_RAW:
            key = _clip_key(mods + [leaf])
        elif "/".join(mods) in bn:
            key = _clip_key(mods) + "." + _BN_LEAF[leaf]
        elif mods[-1] == "ln":  # LNf32's inner flax LayerNorm
            key = _clip_key(mods[:-1]) + "." + {"scale": "weight",
                                                "bias": "bias"}[leaf]
        elif mods[-1] in ("q_proj", "k_proj", "v_proj") and \
                mods[-2] == "attn":  # a transformer block: packed in_proj
            packed.setdefault(_clip_key(mods[:-1]), {})[
                f"{mods[-1]}/{leaf}"] = arr
            continue
        elif leaf == "kernel":
            state[_clip_key(mods) + ".weight"] = _kernel_to_torch(arr)
            continue
        else:
            key = _clip_key(mods) + "." + leaf
        state[key] = torch.from_numpy(arr.copy())
    for key, parts in packed.items():
        qkv = ("q_proj", "k_proj", "v_proj")
        state[f"{key}.in_proj_weight"] = torch.from_numpy(np.concatenate(
            [parts[f"{p}/kernel"].T for p in qkv]))
        state[f"{key}.in_proj_bias"] = torch.from_numpy(np.concatenate(
            [parts[f"{p}/bias"] for p in qkv]))
    for mod_path in bn:
        state[_clip_key(mod_path.split("/")) + ".num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return state


def vggish_state_from_jax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX VGGish tree -> the port's (and torchvggish's) state dict:
    ``features_N`` / ``embeddings_N`` back to ``features.N`` /
    ``embeddings.N``. ``embeddings_0``'s rows are in NHWC flatten order on
    both sides, so they transpose like any dense kernel."""
    return _to_state(params, lambda mod_path: mod_path.replace("_", "."))


def seeded_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic random weights in place: every conv kernel
    ``N(0, 1 / fan_in)`` (LeCun normal), conv biases zero, batch norms the
    identity (weight 1, bias 0, mean 0, var 1). Draws run on the CPU from
    ``torch.Generator().manual_seed(seed)`` in ``named_parameters`` order,
    so the weights do not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
                p.copy_(w.to(p.device))
            elif name.endswith("weight"):  # batch-norm scale
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.fill_(1.0)
            elif name.endswith("running_mean") or \
                    name.endswith("num_batches_tracked"):
                b.zero_()
    return module
