"""YAML option parsing with the reference toolbox's key semantics, copied
from ``edvr_tpu/utils/options.py`` (reference:
basicsr/utils/options.py:31-89). ``yaml`` is imported only where a YAML
text is read, so options given as a dict need no ``yaml``.
"""

from __future__ import annotations

import os.path as osp


def yaml_load(s: str):
    """Load YAML from a string or a path to a file."""
    import yaml
    if s.endswith(('.yml', '.yaml')):
        with open(s, 'r') as f:
            return yaml.load(f, Loader=yaml.SafeLoader)
    return yaml.load(s, Loader=yaml.SafeLoader)


def _prepare_datasets(opt):
    """Inject phase/scale into each dataset block; expand dataroots."""
    scale = opt.get('scale')
    for phase_key, ds in opt.get('datasets', {}).items():
        # 'test_1', 'test_2', ... are all 'test' phases
        ds['phase'] = phase_key.split('_')[0]
        if scale is not None:
            ds['scale'] = scale
        for root_key in ('dataroot_gt', 'dataroot_lq'):
            if ds.get(root_key) is not None:
                ds[root_key] = osp.expanduser(ds[root_key])


def _layout_dirs(opt, is_train):
    """Compute the run's output directory tree under path.root."""
    paths = opt['path']
    if is_train:
        exp = osp.join(paths['root'], 'experiments', opt['name'])
        paths.update(
            experiments_root=exp,
            models=osp.join(exp, 'models'),
            training_states=osp.join(exp, 'training_states'),
            log=exp,
            visualization=osp.join(exp, 'visualization'))
    else:
        res = osp.join(paths['root'], 'results', opt['name'])
        paths.update(results_root=res, log=res,
                     visualization=osp.join(res, 'visualization'))


def parse_dict(opt: dict, is_train: bool = True,
               root: str | None = None) -> dict:
    """Add the derived keys to an option dict, in place: ``is_train``,
    per-dataset ``phase``/``scale``, ``~`` expansion and the output
    directory layout under ``root`` (default: the working directory)."""
    opt['is_train'] = is_train
    _prepare_datasets(opt)
    paths = opt.setdefault('path', {})
    for key, val in paths.items():
        if val is not None and ('resume_state' in key
                                or 'pretrain_network' in key):
            paths[key] = osp.expanduser(val)
    paths['root'] = osp.abspath(root) if root else osp.abspath('.')
    _layout_dirs(opt, is_train)
    return opt


def parse(opt_path: str, is_train: bool = True, root: str | None = None):
    """Parse an option file (see :func:`parse_dict`)."""
    return parse_dict(yaml_load(opt_path), is_train, root)


def dict2str(opt, indent_level: int = 1) -> str:
    """Format a nested option dict for logging."""
    pad = ' ' * (indent_level * 2)
    lines = ['']
    for k, v in opt.items():
        if isinstance(v, dict):
            lines.append(f'{pad}{k}:[{dict2str(v, indent_level + 1)}{pad}]')
        else:
            lines.append(f'{pad}{k}: {v}')
    return '\n'.join(lines) + '\n'
