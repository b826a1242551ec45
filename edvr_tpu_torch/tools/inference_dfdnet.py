"""DFDNet face restoration over a folder of photos, the counterpart of
``inference/inference_dfdnet.py`` (reference: inference/inference_dfdnet.py):
dlib detection and 5 / 68 landmarks -> a 512 px crop aligned to the FFHQ
template -> DFDNet with the part dictionary -> the inverse-affine paste into
the upscaled photo::

    python -m edvr_tpu_torch.tools.inference_dfdnet --test_path DIR
        [--model_path DFDNet.pth] [--dict_path DFDNet_dict_512.pth]
        [--upscale_factor 2] [--device cpu]

``--model_path`` is a BasicSR ``.pth`` (``python -m
edvr_tpu_torch.convert.official --source DFDNet`` writes one from the
official file); its spectral norms are folded as it is read.
``--dict_path`` is the official dictionary, read by ``torch.load``. The
network runs on ``cuda`` unless ``--device`` says otherwise. dlib and its
model files are needed for the detection; :func:`restore_face` and
:func:`get_part_location` work without them.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch


def get_part_location(landmarks):
    """The part windows (left eye, right eye, nose, mouth) as (1, 4) int
    arrays (x0, y0, x1, y1) from 68 landmarks (reference:
    inference/inference_dfdnet.py:14-59)."""
    map_left_eye = list(np.hstack((range(17, 22), range(36, 42))))
    map_right_eye = list(np.hstack((range(22, 27), range(42, 48))))
    map_nose = list(range(29, 36))
    map_mouth = list(range(48, 68))

    def part_location(landmarks, map_idx):
        part = landmarks[map_idx]
        mean = np.mean(part, axis=0)
        # half window: max(spread / 2, 16)
        half_len = np.max((np.max(np.max(part, 0) - np.min(part, 0)) / 2,
                           16))
        loc = np.hstack((mean - half_len + 1, mean + half_len)).astype(int)
        return loc[None]

    return tuple(part_location(landmarks, m) for m in (
        map_left_eye, map_right_eye, map_nose, map_mouth))


def load_dfdnet(model_path, device):
    """DFDNet (64 features) from a BasicSR ``.pth``, spectral norms folded,
    loaded strictly, in eval mode on ``device``."""
    from edvr_tpu_torch.archs.dfdnet_arch import DFDNet
    from edvr_tpu_torch.convert import (fold_spectral_norm,
                                        load_state_dict_file)
    net = DFDNet(num_feat=64)
    net.load_state_dict(fold_spectral_norm(load_state_dict_file(model_path)),
                        strict=True)
    return net.eval().to(device)


def dict_to(dict_feat, device):
    """The part dictionary ``{size: {part: tensor}}`` on ``device``, in
    float32."""
    return {size: {part: torch.as_tensor(t).float().to(device)
                   for part, t in parts.items()}
            for size, parts in dict_feat.items()}


def restore_face(net, face, part_locations, dict_feat):
    """One aligned 512 px RGB uint8 face through ``net`` (on its device):
    the restored face, RGB uint8."""
    device = next(net.parameters()).device
    x = torch.from_numpy(face.astype(np.float32) / 255. * 2 - 1)
    x = x.permute(2, 0, 1)[None].to(device)
    with torch.no_grad():
        out = net(x, part_locations, dict_feat)
    res = ((out[0] + 1) / 2).permute(1, 2, 0).cpu().numpy()
    return (np.clip(res, 0, 1) * 255.).round().astype(np.uint8)


def main(args=None):
    import cv2

    from edvr_tpu_torch.models.base_model import resolve_device
    from edvr_tpu_torch.utils import imwrite
    from edvr_tpu_torch.utils.face_util import FaceRestorationHelper

    parser = argparse.ArgumentParser()
    parser.add_argument('--upscale_factor', type=int, default=2)
    parser.add_argument('--model_path', type=str,
                        default='experiments/pretrained_models/DFDNet.pth')
    parser.add_argument(
        '--dict_path', type=str,
        default='experiments/pretrained_models/DFDNet_dict_512.pth')
    parser.add_argument('--test_path', type=str, default='datasets/TestWhole')
    parser.add_argument('--upsample_num_times', type=int, default=1)
    parser.add_argument('--save_inverse_affine', action='store_true')
    parser.add_argument('--only_keep_largest', action='store_true')
    parser.add_argument('--detection_path', type=str,
                        default='experiments/pretrained_models/dlib/'
                        'mmod_human_face_detector.dat')
    parser.add_argument('--landmark5_path', type=str,
                        default='experiments/pretrained_models/dlib/'
                        'shape_predictor_5_face_landmarks.dat')
    parser.add_argument('--landmark68_path', type=str,
                        default='experiments/pretrained_models/dlib/'
                        'shape_predictor_68_face_landmarks.dat')
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda')")
    args = parser.parse_args(args)

    device = resolve_device(args.device)
    result_root = f'results/DFDNet/{osp.basename(args.test_path)}'
    net = load_dfdnet(args.model_path, device)
    dict_feat = dict_to(torch.load(args.dict_path, map_location='cpu',
                                   weights_only=True), device)
    face_helper = FaceRestorationHelper(args.upscale_factor, face_size=512)
    face_helper.init_dlib(args.detection_path, args.landmark5_path,
                          args.landmark68_path)

    for img_path in sorted(glob.glob(osp.join(args.test_path, '*'))):
        img_name = osp.basename(img_path)
        print(f'Processing {img_name} ...')
        stem = osp.splitext(img_name)[0]
        face_helper.clean_all()
        num_det_faces = face_helper.detect_faces(
            img_path, upsample_num_times=args.upsample_num_times,
            only_keep_largest=args.only_keep_largest)
        face_helper.get_face_landmarks_5()
        face_helper.warp_crop_faces(
            osp.join(result_root, 'cropped_faces', img_name),
            osp.join(result_root, 'inverse_affine', img_name)
            if args.save_inverse_affine else None)
        if face_helper.get_face_landmarks_68() != num_det_faces:
            raise RuntimeError('Detected faces and landmark-68 faces are '
                               'different.')
        for idx, (cropped_face, landmarks) in enumerate(zip(
                face_helper.cropped_faces, face_helper.all_landmarks_68)):
            res = cropped_face if landmarks is None else restore_face(
                net, cropped_face, get_part_location(landmarks), dict_feat)
            imwrite(cv2.cvtColor(res, cv2.COLOR_RGB2BGR),
                    osp.join(result_root, 'restored_faces',
                             f'{stem}_{idx:02d}.png'))
            face_helper.add_restored_face(
                np.ascontiguousarray(res[..., ::-1]))  # to BGR
        face_helper.paste_faces_to_input_image(
            osp.join(result_root, 'final_results', img_name))
    print(f'All results are saved in {result_root}')


if __name__ == '__main__':
    main()
