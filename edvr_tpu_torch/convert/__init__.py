"""Weights into the port: flax parameter trees and BasicSR checkpoints.

``jax_params_to_state_dict`` is the inverse of
``edvr_tpu/convert/torch_import.py``: it maps a flax parameter tree (as
nested dicts of numpy arrays) onto BasicSR's flat state-dict keys, with
conv kernels HWIO -> OIHW (the layers of the ported architectures).
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


def _torch_key(path) -> str:
    tokens = []
    for scope in path[:-1]:
        if scope == 'conv':  # the flax Conv2d wrapper's inner scope
            continue
        m = re.fullmatch(r'block_(\d+)', scope)
        if m:  # make_layer's Sequential children
            tokens.append(m.group(1))
            continue
        m = _MODULE_DICT_RE.match(scope) or _MODULE_LIST_RE.match(scope)
        tokens.extend(m.groups() if m else [scope])
    tokens.append('weight' if path[-1] == 'kernel' else path[-1])
    return '.'.join(tokens)


def _torch_layout(value: np.ndarray) -> np.ndarray:
    # conv kernels (flax 'kernel', DCNv2Pack 'weight') HWIO -> OIHW
    return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value


def jax_params_to_state_dict(params: dict) -> dict:
    """Flax params (nested dicts of arrays) -> {BasicSR key: tensor}."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                arr = _torch_layout(np.asarray(v))
                out[_torch_key(path + (k,))] = torch.from_numpy(
                    np.array(arr, dtype=np.float32, order='C'))

    walk(params, ())
    return out


def load_state_dict_file(path: str, param_key: str = 'params') -> dict:
    """Read a checkpoint into a state dict.

    A ``.pth`` is a BasicSR checkpoint: a state dict, or one under
    ``param_key``, with any DDP ``module.`` prefix stripped
    (reference: base_model.py:238-262). Any other file must be an
    ``edvr_tpu`` native checkpoint (magic header, then a pickled tree of
    numpy arrays); its flax params are converted.
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
    return jax_params_to_state_dict(blob.get(param_key, blob))
