"""Weights into the port: flax parameter trees and BasicSR checkpoints.

``jax_params_to_state_dict`` is the inverse of
``edvr_tpu/convert/torch_import.py``: it maps a flax parameter tree (as
nested dicts of numpy arrays), a BatchNorm ``batch_stats`` tree and
StyleGAN2's ``noises`` collection onto BasicSR's flat state-dict keys, with
conv kernels HWIO -> OIHW (3-D: DHWIO -> OIDHW) and Dense kernels
transposed (the layers of the ported architectures).
``load_state_dict_file`` reads a BasicSR ``.pth`` or an ``edvr_tpu``
``.ckpt`` checkpoint into such a state dict.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

# flax scope ``<name>_l<i>`` is BasicSR's ``nn.ModuleDict`` entry
# ``<name>.l<i>`` for these names (PCDAlignment); other ``_l<i>`` names
# (TSAFusion's ``spatial_attn_l1``) are plain attributes
_MODULE_DICTS = ('offset_conv1', 'offset_conv2', 'offset_conv3', 'dcn_pack',
                 'feat_conv')
_MODULE_DICT_RE = re.compile(
    r'^(' + '|'.join(_MODULE_DICTS) + r')_(l\d+)$')
# flax scope ``resblock_l1_<i>`` is PredeblurModule's ``nn.ModuleList``
# entry ``resblock_l1.<i>``; its ``resblock_l2_<j>`` are plain attributes
_MODULE_LIST_RE = re.compile(r'^(resblock_l1)_(\d+)$')

# header of an edvr_tpu native checkpoint (edvr_tpu/models/base_model.py);
# only files that carry it are unpickled
CKPT_MAGIC = b'EDVRTPU.CKPT.v1\n'


# flax scopes ``<name>_<i>`` that are BasicSR ``nn.Sequential`` or
# ``nn.ModuleList`` entries ``<name>.<i>``: RCAN's ``rcab`` and
# ``attention``, DUF's ``dense_blocks``, SpyNet's and TOFlow's
# ``basic_module`` (both the flow modules and their layers)
_SEQ_RE = re.compile(r'^(rcab|attention|dense_blocks|basic_module)_(\d+)$')
# the Upsample's ``up_<i>`` conv is its ``nn.Sequential`` child 2 i (a pixel
# shuffle follows each conv)
_UP_RE = re.compile(r'^up_(\d+)$')
# VGGFeatureExtractor's ``features_<index>`` (torchvision's layer index)
_FEATURES_RE = re.compile(r'^features_(\d+)$')
# StyleGAN2's flax scopes ``<name>_<i>`` that are BasicSR ``nn.Sequential``
# or ``nn.ModuleList`` entries ``<name>.<i>``, and ConvLayer's ``seq_<i>``
_SG2_SEQ_RE = re.compile(
    r'^(style_mlp|style_convs|to_rgbs|conv_body|final_linear)_(\d+)$')
_SG2_LAYER_RE = re.compile(r'^seq_(\d+)$')
# StyleGAN2 leaves that name a child module's parameter: ConvLayer's
# ``seq_<i>_bias`` (its FusedLeakyReLU), StyleConv's ``activate_bias`` and
# the generator's ``constant_input_weight``
_SG2_LEAF_RE = re.compile(r'^(seq_(\d+)|activate|constant_input)_'
                          r'(bias|weight)$')
# flax NHWC-shaped StyleGAN2 leaves (1, h, w, c) kept as (1, c, h, w):
# the constant input, ToRGB's bias and the stored noises
_NHWC_LEAVES = ('constant_input_weight', 'bias', 'noise')
# flax leaf name -> BasicSR's: conv and Dense kernels and BatchNorm's
# scale; in batch_stats, BatchNorm's running statistics
_LEAF = {'kernel': 'weight', 'scale': 'weight'}
_STATS_LEAF = {'mean': 'running_mean', 'var': 'running_var'}


def _torch_key(path, vgg_names=None, leaf=_LEAF) -> str:
    tokens = []
    scopes = path[:-1]
    for i, scope in enumerate(scopes):
        # the flax Conv2d wrapper's inner scope; of the modules named
        # ``conv``, RCAN's ResidualGroup's (a ``block_<i>`` child) keeps its
        # name, WarpAlignPack's dense conv is the pack's own weight
        if scope == 'conv' and (i == len(scopes) - 1 or not re.fullmatch(
                r'block_\d+', scopes[i - 1] if i else '')):
            continue
        m = re.fullmatch(r'block_(\d+)', scope)
        if m:  # make_layer's Sequential children
            tokens.append(m.group(1))
            continue
        m = _UP_RE.match(scope)
        if m:
            tokens.append(str(2 * int(m.group(1))))
            continue
        m = _FEATURES_RE.match(scope)
        if m and vgg_names is not None:
            tokens += ['vgg_net', vgg_names[int(m.group(1))]]
            continue
        m = _SG2_LAYER_RE.match(scope)
        if m:
            tokens.append(m.group(1))
            continue
        m = (_MODULE_DICT_RE.match(scope) or _MODULE_LIST_RE.match(scope)
             or _SEQ_RE.match(scope) or _SG2_SEQ_RE.match(scope))
        tokens.extend(m.groups() if m else [scope])
    m = _SG2_LEAF_RE.match(path[-1])
    if m:
        tokens += [m.group(2) or m.group(1), m.group(3)]
    else:
        tokens.append(leaf.get(path[-1], path[-1]))
    return '.'.join(tokens)


def _torch_layout(value: np.ndarray, name: str = '') -> np.ndarray:
    # StyleGAN2's NHWC-shaped leaves -> NCHW; conv kernels (flax 'kernel',
    # DCNv2Pack and EqualConv2d 'weight') HWIO -> OIHW, Dense and
    # EqualLinear kernels (in, out) -> (out, in); a flax Conv3d 'kernel'
    # (kt, kh, kw, in, out) -> (out, in, kt, kh, kw), told apart by its
    # name: ModulatedConv2d's 5-D 'weight' is BasicSR's layout already
    if value.ndim == 5 and name == 'kernel':
        return value.transpose(4, 3, 0, 1, 2)
    if value.ndim == 4 and name.startswith(_NHWC_LEAVES):
        return value.transpose(0, 3, 1, 2)
    if value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value.T if value.ndim == 2 else value


def jax_params_to_state_dict(params: dict, batch_stats: dict | None = None,
                             vgg_type: str | None = None,
                             noises: dict | None = None) -> dict:
    """Flax params (nested dicts of arrays) -> {BasicSR key: tensor}.

    ``batch_stats`` (flax's BatchNorm collection) adds each BatchNorm's
    ``running_mean``, ``running_var`` and a zero ``num_batches_tracked``;
    ``noises`` (StyleGAN2Generator's collection) its ``noises.noise<i>``
    buffers.
    ``vgg_type`` names a VGGFeatureExtractor's ``features_<index>`` scopes
    by that VGG's layer names (``vgg_net.conv1_1``, ...)."""
    vgg_names = None
    if vgg_type is not None:
        from edvr_tpu_torch.archs.vgg_arch import layer_names
        vgg_names = layer_names(vgg_type)
    out = {}

    def walk(node, path, leaf):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), leaf)
                continue
            key = _torch_key(path + (k,), vgg_names, leaf)
            out[key] = torch.from_numpy(np.array(
                _torch_layout(np.asarray(v), k), dtype=np.float32,
                order='C'))
            if leaf is _STATS_LEAF and k == 'mean':
                out[key.rsplit('.', 1)[0] + '.num_batches_tracked'] = \
                    torch.tensor(0)

    walk(params, (), _LEAF)
    walk(batch_stats or {}, (), _STATS_LEAF)
    walk(noises or {}, ('noises',), _LEAF)
    return out


def fold_spectral_norm(state: dict) -> dict:
    """Fold spectral-norm parametrisations into plain weights (the port's
    copy of ``edvr_tpu/convert/torch_import.py::fold_spectral_norm``).

    A checkpoint of spectral-normalised modules stores ``weight_orig``,
    ``weight_u`` and ``weight_v``; the weight in use is ``W / sigma`` with
    ``sigma = u^T (W_mat v)``, ``W_mat`` the weight as (out, -1). Other
    keys pass through. Used to read DFDNet's checkpoints, which the port
    runs for inference only."""
    out = {}
    for key, val in state.items():
        if key.endswith('weight_orig'):
            base = key[:-len('weight_orig')]  # keeps the trailing dot
            w = torch.as_tensor(val)
            u = torch.as_tensor(state[f'{base}weight_u'])
            v = torch.as_tensor(state[f'{base}weight_v'])
            sigma = u @ (w.reshape(w.shape[0], -1) @ v)
            out[f'{base}weight'] = w / sigma
        elif not key.endswith(('weight_u', 'weight_v')):
            out[key] = val
    return out


def load_state_dict_file(path: str, param_key: str = 'params') -> dict:
    """Read a checkpoint into a state dict.

    A ``.pth`` is a BasicSR checkpoint: a state dict, or one under
    ``param_key``, with any DDP ``module.`` prefix stripped
    (reference: base_model.py:238-262). Any other file must be an
    ``edvr_tpu`` native checkpoint (magic header, then a pickled tree of
    numpy arrays); its flax params, and its ``batch_stats`` if it has
    them, are converted.
    """
    if path.endswith('.pth'):
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        if param_key is not None and param_key in ckpt:
            ckpt = ckpt[param_key]
        return {(k[7:] if k.startswith('module.') else k): v
                for k, v in ckpt.items()}
    with open(path, 'rb') as f:
        if f.read(len(CKPT_MAGIC)) != CKPT_MAGIC:
            raise ValueError(
                f'{path} is neither a .pth nor an edvr_tpu checkpoint '
                f'(missing the {CKPT_MAGIC!r} header); refusing to unpickle '
                'it')
        blob = pickle.load(f)
    # a discriminator's checkpoint carries its BatchNorm statistics beside
    # the params (edvr_tpu/models/srgan_model.py:248-252)
    return jax_params_to_state_dict(blob.get(param_key, blob),
                                    blob.get('batch_stats'))
