"""Checkpoints: the JAX package's msgpack ``.ckpt`` files and the reference's
torch ``.pth`` files, as variable trees for ``convert.load_jax_variables``.

Counterpart of ``hrviton_tpu/train/checkpoint.py``:

  * ``load_pytree`` / ``restore_into``: a ``.ckpt`` written by the JAX
    package's ``save_pytree`` (flax's msgpack format: arrays as extension
    type 1 holding (shape, dtype name, row-major bytes), numpy scalars as
    type 3, complex numbers as type 2, arrays over 1 GiB as
    ``__msgpack_chunked_array__`` dicts). Decoded with the ``msgpack``
    package, imported when a file is read. bfloat16 arrays come back as
    float32 arrays of the same values (numpy has no bfloat16).
  * ``save_pytree``: writes a tree of numpy arrays in the same format, byte
    for byte as the JAX function writes it (``cli/convert_checkpoint.py``);
  * ``convert_tocg`` (mtviton.pth, ConditionGenerator),
    ``convert_spade_gen`` (gen.pth, including the legacy key remap
    'ace'->'alias', '.Spade'->'', reference test_generator.py:77-86),
    ``convert_cond_discriminator`` (D_*.pth) and the backbones'
    ``convert_vgg19`` / ``convert_alexnet`` / ``convert_vgg16`` /
    ``convert_squeezenet`` / ``convert_lpips_alex`` (torchvision and LPIPS
    v0.1 keys): torch state dicts to the JAX variable layout (conv kernels
    OIHW -> HWIO).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

__all__ = ["save_pytree", "load_pytree", "restore_into",
           "load_torch_state_dict", "convert_tocg", "convert_spade_gen",
           "convert_cond_discriminator", "convert_vgg19", "convert_alexnet",
           "convert_vgg16", "convert_squeezenet", "convert_lpips_alex"]


# ----------------------------------------------------------------- file I/O

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK = 2 ** 30       # flax's limit of bytes in one array leaf


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _state(tree):
    """flax's state dict of nested dicts as the JAX ``save_pytree`` builds
    it: string keys in sorted order (a JAX pytree rebuilds a dict so), numpy
    scalars as 0-d arrays (``jax.device_get``), oversized arrays split into
    chunks."""
    if isinstance(tree, Mapping):
        return {str(k): _state(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK:
        flat = tree.reshape(-1)
        step = max(1, _MAX_CHUNK // tree.dtype.itemsize)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {_CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def save_pytree(tree: Mapping, path: str) -> None:
    """Write ``tree`` (nested dicts of numpy arrays and scalars) as the JAX
    package's ``save_pytree`` writes it: flax's msgpack state dict."""
    import msgpack
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(_state(tree), default=_ext_pack,
                              strict_types=True))


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_pytree(path: str) -> Dict:
    """The nested dict of arrays in a ``.ckpt`` file."""
    import msgpack
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def _restore(template, state, path=()):
    if not isinstance(template, Mapping):
        return state
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(f"checkpoint lacks keys {sorted(missing)} at "
                         f"/{'/'.join(path)}")
    return {k: _restore(v, state[str(k)], path + (str(k),))
            for k, v in template.items()}


def restore_into(template: Mapping, path: str) -> Dict:
    """Load a checkpoint into the structure of ``template`` (nested dicts):
    every key of the template must be in the file (keys the template lacks
    are dropped), as flax's ``from_state_dict`` restores a dict."""
    return _restore(template, load_pytree(path))


# ----------------------------------------------------------- torch helpers

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` state dict as numpy arrays. Loaded with
    ``weights_only=True``: a file holding a pickled module, not a state
    dict, is refused rather than unpickled."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _k(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


class _TreeBuilder:
    def __init__(self):
        self.params: Dict = {}
        self.stats: Dict = {}
        self.aux: Dict = {}

    @staticmethod
    def _set(root, path, value):
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    def conv(self, sd, tkey, *path, spectral=False):
        if spectral:
            self._set(self.params, (*path, "kernel"), _k(sd[tkey + ".weight_orig"]))
            self._set(self.aux, (*path, "u"), sd[tkey + ".weight_u"])
            if tkey + ".weight_v" in sd:
                self._set(self.aux, (*path, "v"), sd[tkey + ".weight_v"])
            if tkey + ".bias" in sd:
                self._set(self.params, (*path, "bias"), sd[tkey + ".bias"])
        else:
            self._set(self.params, (*path, "conv", "kernel"), _k(sd[tkey + ".weight"]))
            if tkey + ".bias" in sd:
                self._set(self.params, (*path, "conv", "bias"), sd[tkey + ".bias"])

    def bn(self, sd, tkey, *path):
        self._set(self.params, (*path, "scale"), sd[tkey + ".weight"])
        self._set(self.params, (*path, "bias"), sd[tkey + ".bias"])
        self._set(self.stats, (*path, "mean"), sd[tkey + ".running_mean"])
        self._set(self.stats, (*path, "var"), sd[tkey + ".running_var"])

    def variables(self) -> Dict:
        out = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        if self.aux:
            out["aux"] = self.aux
        return out


# ------------------------------------------------------------------- tocg

def _resblock(b: _TreeBuilder, sd, tprefix: str, fprefix: str, scale: str):
    """ResBlock (networks.py:171-198): scale conv + block indices 0/1/3/4."""
    scale_key = f"{tprefix}.scale.1" if scale == "up" else f"{tprefix}.scale"
    b.conv(sd, scale_key, fprefix, "scale_conv")
    b.conv(sd, f"{tprefix}.block.0", fprefix, "conv1")
    b.bn(sd, f"{tprefix}.block.1", fprefix, "norm1")
    b.conv(sd, f"{tprefix}.block.3", fprefix, "conv2")
    b.bn(sd, f"{tprefix}.block.4", fprefix, "norm2")


def convert_tocg(sd: Dict[str, np.ndarray], out_layer: str = "relu") -> Dict:
    """mtviton.pth -> ConditionGenerator variables (networks.py:13-94 layout)."""
    b = _TreeBuilder()
    for i in range(5):
        _resblock(b, sd, f"ClothEncoder.{i}", f"ClothEncoder_{i}", "down")
        _resblock(b, sd, f"PoseEncoder.{i}", f"PoseEncoder_{i}", "down")
    _resblock(b, sd, "conv", "conv", "same")
    for i in range(5):
        _resblock(b, sd, f"SegDecoder.{i}", f"SegDecoder_{i}", "up")
        b.conv(sd, f"flow_conv.{i}", f"flow_conv_{i}")
    for k in range(4):
        b.conv(sd, f"conv1.{k}", f"conv1_{k}")
        b.conv(sd, f"conv2.{k}", f"conv2_{k}")
        b.conv(sd, f"bottleneck.{k}.0", f"bottleneck_{k}")
    if out_layer == "relu":
        _resblock(b, sd, "out_layer", "out_layer", "same")
    else:
        _resblock(b, sd, "out_layer.0", "out_layer_res", "same")
        b.conv(sd, "out_layer.1", "out_layer_conv")
    return b.variables()


# -------------------------------------------------------------- SPADE gen

def _legacy_remap(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """'ace'->'alias', '.Spade'->'' (test_generator.py:82-83)."""
    return {k.replace("ace", "alias").replace(".Spade", ""): v
            for k, v in sd.items()}


def _spade_norm(b: _TreeBuilder, sd, tprefix: str, *fpath):
    b._set(b.params, (*fpath, "noise_scale"), sd[f"{tprefix}.noise_scale"])
    b.conv(sd, f"{tprefix}.conv_shared.0", *fpath, "conv_shared")
    b.conv(sd, f"{tprefix}.conv_gamma", *fpath, "conv_gamma")
    b.conv(sd, f"{tprefix}.conv_beta", *fpath, "conv_beta")


def _spade_resblock(b: _TreeBuilder, sd, tprefix: str, fprefix: str):
    has_shortcut = f"{tprefix}.conv_s.weight_orig" in sd
    b.conv(sd, f"{tprefix}.conv_0", fprefix, "conv_0", spectral=True)
    b.conv(sd, f"{tprefix}.conv_1", fprefix, "conv_1", spectral=True)
    _spade_norm(b, sd, f"{tprefix}.norm_0", fprefix, "norm_0")
    _spade_norm(b, sd, f"{tprefix}.norm_1", fprefix, "norm_1")
    if has_shortcut:
        b.conv(sd, f"{tprefix}.conv_s", fprefix, "conv_s", spectral=True)
        _spade_norm(b, sd, f"{tprefix}.norm_s", fprefix, "norm_s")


def convert_spade_gen(sd: Dict[str, np.ndarray],
                      num_upsampling_layers: str = "most") -> Dict:
    """gen.pth -> SPADEGenerator variables (network_generator.py:176-245)."""
    sd = _legacy_remap(sd)
    b = _TreeBuilder()
    for i in range(8):
        b.conv(sd, f"conv_{i}", f"conv_{i}")
    blocks = ["head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2",
              "up_3"]
    if num_upsampling_layers == "most":
        blocks.append("up_4")
    for name in blocks:
        _spade_resblock(b, sd, name, name)
    b.conv(sd, "conv_img", "conv_img")
    return b.variables()


# ------------------------------------------------------- cond discriminator

def convert_cond_discriminator(sd: Dict[str, np.ndarray], num_d: int = 2,
                               n_layers: int = 3) -> Dict:
    """D_*.pth (define_D's default flags: no spectral norm or dropout,
    instance norm, getIntermFeat=False) -> CondMultiscaleDiscriminator
    variables. torch flattens each sub-D to the Sequential indices
    {0, 2, 5, 8, 11} (networks.py:351-398)."""
    b = _TreeBuilder()
    seq_idx = [0] + [2 + 3 * (n - 1) for n in range(1, n_layers)] + \
        [2 + 3 * (n_layers - 1), 2 + 3 * (n_layers - 1) + 3]
    for d in range(num_d):
        for j, si in enumerate(seq_idx):
            b.conv(sd, f"layer{d}.{si}", f"discriminator_{d}", f"layer{j}_conv")
    return b.variables()


# ------------------------------------------------------------- backbones

_VGG19_CONVS = [
    ("features.0", "conv1_1"), ("features.2", "conv1_2"),
    ("features.5", "conv2_1"), ("features.7", "conv2_2"),
    ("features.10", "conv3_1"), ("features.12", "conv3_2"),
    ("features.14", "conv3_3"), ("features.16", "conv3_4"),
    ("features.19", "conv4_1"), ("features.21", "conv4_2"),
    ("features.23", "conv4_3"), ("features.25", "conv4_4"),
    ("features.28", "conv5_1"),
]

_ALEX_CONVS = [("features.0", "conv1"), ("features.3", "conv2"),
               ("features.6", "conv3"), ("features.8", "conv4"),
               ("features.10", "conv5")]

_VGG16_CONVS = [
    ("features.0", "conv1_1"), ("features.2", "conv1_2"),
    ("features.5", "conv2_1"), ("features.7", "conv2_2"),
    ("features.10", "conv3_1"), ("features.12", "conv3_2"),
    ("features.14", "conv3_3"),
    ("features.17", "conv4_1"), ("features.19", "conv4_2"),
    ("features.21", "conv4_3"),
    ("features.24", "conv5_1"), ("features.26", "conv5_2"),
    ("features.28", "conv5_3"),
]

# torchvision squeezenet1_1 feature indices -> fire modules
_SQUEEZE_FIRES = [(3, "fire2"), (4, "fire3"), (6, "fire4"), (7, "fire5"),
                  (9, "fire6"), (10, "fire7"), (11, "fire8"), (12, "fire9")]


def _convs(sd, table, prefix=()) -> Dict:
    b = _TreeBuilder()
    for tkey, fkey in table:
        b.conv(sd, tkey, *prefix, fkey)
    return b.variables()


def convert_vgg19(sd: Dict[str, np.ndarray]) -> Dict:
    """torchvision vgg19 state_dict -> Vgg19Features variables."""
    return _convs(sd, _VGG19_CONVS)


def convert_alexnet(sd: Dict[str, np.ndarray], prefix=()) -> Dict:
    return _convs(sd, _ALEX_CONVS, prefix)


def convert_vgg16(sd: Dict[str, np.ndarray], prefix=()) -> Dict:
    return _convs(sd, _VGG16_CONVS, prefix)


def convert_squeezenet(sd: Dict[str, np.ndarray], prefix=()) -> Dict:
    b = _TreeBuilder()
    b.conv(sd, "features.0", *prefix, "conv1")
    for idx, name in _SQUEEZE_FIRES:
        b.conv(sd, f"features.{idx}.squeeze", *prefix, name, "squeeze")
        b.conv(sd, f"features.{idx}.expand1x1", *prefix, name, "expand1x1")
        b.conv(sd, f"features.{idx}.expand3x3", *prefix, name, "expand3x3")
    return b.variables()


def convert_lpips_alex(lin_sd: Dict[str, np.ndarray],
                       alexnet_sd: Dict[str, np.ndarray]) -> Dict:
    """LPIPS v0.1 alex.pth lin heads + torchvision alexnet -> LPIPSAlex
    variables. alex.pth keys: lin{i}.model.1.weight (1x1 conv, no bias;
    networks_basic.py:104-120)."""
    b = _TreeBuilder()
    for tkey, fkey in _ALEX_CONVS:
        b.conv(alexnet_sd, tkey, "alexnet", fkey)
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:  # some exports drop the dropout module
            key = f"lin{i}.model.0.weight"
        b._set(b.params, (f"lin{i}", "conv", "kernel"), _k(lin_sd[key]))
    return b.variables()
