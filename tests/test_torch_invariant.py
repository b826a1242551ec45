"""``python -m edvr_tpu_torch.tools.train_invariant`` (the port's twin of
``scripts/dev/train_fast_invariant.py``) on the CPU: its clips against the
JAX script's ``make_video_dataset``, and its plumbing at ``--iters 40
--calibrate`` on a cut size (a narrow EDVR, 32 px GT crops, batch 2: ~120
ms an iteration on one CPU thread, so 40 keep the test near 5 s); the
gates themselves need the 900 iterations of the full size, which run on
the card (``chip_smoke.py`` learning_invariant)."""

import json
import os.path as osp
import sys

import cv2
import numpy as np
import pytest

from edvr_tpu_torch.tools import train_invariant as ti
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CUT = dict(hw=32, clips=2, batch=2,
           net=dict(num_feat=8, deformable_groups=2, num_extract_block=1,
                    num_reconstruct_block=1))


def test_clips_match_jax_script(tmp_path):
    """The GT PNGs bitwise, the LQ ones (MATLAB imresize in each package)
    within one level, and the meta file."""
    sys.path.insert(0, osp.join(REPO, 'scripts', 'dev'))
    try:
        from train_edvr_smoke import make_video_dataset
    finally:
        sys.path.pop(0)
    kw = dict(num_clips=2, frames=6, hw=32, seed=0)
    make_video_dataset(str(tmp_path / 'jax'), **kw)
    ti.make_video_dataset(str(tmp_path / 'port'), **kw)
    for sub in ('train_sharp', 'train_sharp_bicubic'):
        for clip in ('000', '001'):
            for f in range(6):
                name = osp.join(sub, clip, f'{f:08d}.png')
                got = cv2.imread(str(tmp_path / 'port' / name)).astype(int)
                want = cv2.imread(str(tmp_path / 'jax' / name)).astype(int)
                tol = 0 if sub == 'train_sharp' else 1
                assert np.abs(got - want).max() <= tol, name
    assert (tmp_path / 'port' / 'meta.txt').read_text() == \
        (tmp_path / 'jax' / 'meta.txt').read_text()


def test_cli_calibrate_plumbing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ti, 'SIZE', CUT)
    out = str(tmp_path / 'curve.json')
    result = ti.main(['--iters', '40', '--calibrate', '--device', 'cpu',
                      '--seed', '17', '--out', out])
    with open(out) as f:
        line = json.load(f)
    assert line == json.loads(json.dumps(result))
    assert [it for it, _ in result['curve']] == [0, 40]
    assert all(np.isfinite(db) for _, db in result['curve'])
    assert result['total_gain_db'] == pytest.approx(
        result['curve'][-1][1] - result['curve'][0][1])
    # without an iteration-100 point the post-warm-up gain is the total
    assert result['postwarm_gain_db'] == result['total_gain_db']
    assert result['seed'] == 17 and result['mixed_precision'] is None
    assert result['ms_per_iter'] > 0
    assert 'eval PSNR' in capsys.readouterr().out


def test_cli_gates(monkeypatch):
    with pytest.raises(SystemExit):  # the post-warm-up point is needed
        ti.main(['--iters', '50', '--device', 'cpu'])

    def fake(total, postwarm):
        return lambda *a, **k: dict(
            total_gain_db=total, postwarm_gain_db=postwarm,
            total_ok=total >= ti.GATE_TOTAL_DB,
            postwarm_ok=postwarm >= ti.GATE_POSTWARM_DB)

    monkeypatch.setattr(ti, 'run', fake(0.9, 0.3))
    assert ti.main(['--device', 'cpu'])['total_ok']
    monkeypatch.setattr(ti, 'run', fake(0.3, 0.3))
    with pytest.raises(SystemExit, match='fixed-batch PSNR gain'):
        ti.main(['--device', 'cpu'])
    monkeypatch.setattr(ti, 'run', fake(0.9, 0.05))
    with pytest.raises(SystemExit, match='post-warm-up gain'):
        ti.main(['--device', 'cpu'])
