"""EDVR: video restoration with PCD deformable alignment and TSA fusion
(NCHW), the counterpart of ``edvr_tpu/archs/edvr_arch.py``.

Parameter names are BasicSR's (reference:
basicsr/models/archs/edvr_arch.py). As in the JAX package, the PCD
alignment runs once per window with the frames folded into the batch
(``edvr_tpu/archs/edvr_arch.py:379-391``) instead of the reference's
per-frame loop, so each window makes four DCN calls (L3, L2, L1 and the
cascade), each over all ``num_frame`` frames.

The forward is split into stages, as in the JAX package, so that the
whole-clip evaluation's pyramid mode can compute each frame's pyramid once
per clip: ``extract_pyramid`` (frames -> L1/L2/L3), ``restore_windows``
(gather window features from a clip pyramid, align, fuse, reconstruct) and
``fuse_reconstruct`` (fusion, trunk and upsampling tail).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.arch_util import (DCNv2Pack, ResidualBlockNoBN,
                                            WarpAlignPack, lrelu, make_layer)
from edvr_tpu_torch.data.data_util import generate_frame_indices
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode='bilinear',
                         align_corners=False)


class PredeblurModule(nn.Module):
    """Pre-deblur pyramid (reference: edvr_arch.py:217-269;
    ``edvr_tpu/archs/edvr_arch.py:168-205``). With ``hr_in`` two stride-2
    convs take the HR input down to the LR grid first.

    ``resblock_l1`` is an ``nn.ModuleList`` and ``resblock_l2_1``,
    ``resblock_l2_2`` and ``resblock_l3`` are plain attributes, BasicSR's
    names.
    """

    def __init__(self, num_in_ch=3, num_feat=64, hr_in=False):
        super().__init__()
        nf = num_feat
        self.hr_in = hr_in
        self.conv_first = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        if hr_in:
            self.stride_conv_hr1 = nn.Conv2d(nf, nf, 3, 2, 1)
            self.stride_conv_hr2 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.stride_conv_l2 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.stride_conv_l3 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.resblock_l3 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l2_1 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l2_2 = ResidualBlockNoBN(num_feat=nf)
        self.resblock_l1 = nn.ModuleList(
            [ResidualBlockNoBN(num_feat=nf) for _ in range(5)])

    def forward(self, x):
        feat_l1 = lrelu(self.conv_first(x))
        if self.hr_in:
            feat_l1 = lrelu(self.stride_conv_hr1(feat_l1))
            feat_l1 = lrelu(self.stride_conv_hr2(feat_l1))

        feat_l2 = lrelu(self.stride_conv_l2(feat_l1))
        feat_l3 = lrelu(self.stride_conv_l3(feat_l2))

        feat_l3 = _up2(self.resblock_l3(feat_l3))
        feat_l2 = self.resblock_l2_1(feat_l2) + feat_l3
        feat_l2 = _up2(self.resblock_l2_2(feat_l2))

        for i in range(2):
            feat_l1 = self.resblock_l1[i](feat_l1)
        feat_l1 = feat_l1 + feat_l2
        for i in range(2, 5):
            feat_l1 = self.resblock_l1[i](feat_l1)
        return feat_l1


class PCDAlignment(nn.Module):
    """Pyramid, Cascading and Deformable alignment
    (reference: edvr_arch.py:9-117).

    ``align_variant`` picks the alignment module: ``'dcn'`` (DCNv2Pack,
    the reference's) or ``'tap_shared'`` (WarpAlignPack,
    ``edvr_tpu/archs/edvr_arch.py:48-56``).
    """

    def __init__(self, num_feat=64, deformable_groups=8, align_variant='dcn'):
        super().__init__()
        nf = num_feat
        pack_cls = {'dcn': DCNv2Pack,
                    'tap_shared': WarpAlignPack}[align_variant]
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            level = f'l{i}'
            self.offset_conv1[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
            if i == 3:
                self.offset_conv2[level] = nn.Conv2d(nf, nf, 3, 1, 1)
            else:
                self.offset_conv2[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
                self.offset_conv3[level] = nn.Conv2d(nf, nf, 3, 1, 1)
            self.dcn_pack[level] = pack_cls(
                nf, nf, 3, padding=1, deformable_groups=deformable_groups)
            if i < 3:
                self.feat_conv[level] = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.cas_offset_conv1 = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.cas_offset_conv2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.cas_dcnpack = pack_cls(nf, nf, 3, padding=1,
                                    deformable_groups=deformable_groups)

    def forward(self, nbr_feat_l, ref_feat_l):
        """nbr_feat_l / ref_feat_l: lists of three (n, c, h, w) tensors
        (L1, L2, L3)."""
        upsampled_offset, upsampled_feat = None, None
        feat = None
        for i in range(3, 0, -1):
            level = f'l{i}'
            offset = torch.cat([nbr_feat_l[i - 1], ref_feat_l[i - 1]], dim=1)
            offset = lrelu(self.offset_conv1[level](offset))
            if i == 3:
                offset = lrelu(self.offset_conv2[level](offset))
            else:
                offset = lrelu(self.offset_conv2[level](
                    torch.cat([offset, upsampled_offset], dim=1)))
                offset = lrelu(self.offset_conv3[level](offset))

            feat = self.dcn_pack[level](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[level](
                    torch.cat([feat, upsampled_feat], dim=1))
            if i > 1:
                feat = lrelu(feat)
                # upsample offset x2 and double its magnitude (:106-110)
                upsampled_offset = _up2(offset) * 2
                upsampled_feat = _up2(feat)

        offset = torch.cat([feat, ref_feat_l[0]], dim=1)
        offset = lrelu(self.cas_offset_conv2(
            lrelu(self.cas_offset_conv1(offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    """Temporal-Spatial Attention fusion (reference: edvr_arch.py:120-214).

    Input (b, t, c, h, w) aligned features; output (b, c, h, w).
    """

    def __init__(self, num_feat=64, num_frame=5, center_frame_idx=2):
        super().__init__()
        nf = num_feat
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.temporal_attn2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.feat_fusion = nn.Conv2d(num_frame * nf, nf, 1, 1)

        self.max_pool = nn.MaxPool2d(3, stride=2, padding=1)
        self.avg_pool = nn.AvgPool2d(3, stride=2, padding=1)
        self.spatial_attn1 = nn.Conv2d(num_frame * nf, nf, 1)
        self.spatial_attn2 = nn.Conv2d(nf * 2, nf, 1)
        self.spatial_attn3 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn4 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn5 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn_l1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_l2 = nn.Conv2d(nf * 2, nf, 3, 1, 1)
        self.spatial_attn_l3 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.spatial_attn_add1 = nn.Conv2d(nf, nf, 1)
        self.spatial_attn_add2 = nn.Conv2d(nf, nf, 1)

    def forward(self, aligned_feat):
        b, t, c, h, w = aligned_feat.shape
        # temporal attention: per-pixel correlation with the center frame
        embedding_ref = self.temporal_attn1(
            aligned_feat[:, self.center_frame_idx].clone())
        embedding = self.temporal_attn2(aligned_feat.view(-1, c, h, w))
        embedding = embedding.view(b, t, -1, h, w)
        corr = torch.sum(embedding * embedding_ref.unsqueeze(1), dim=2)
        corr_prob = torch.sigmoid(corr).unsqueeze(2)  # (b, t, 1, h, w)
        aligned_feat = (aligned_feat * corr_prob).view(b, -1, h, w)

        feat = lrelu(self.feat_fusion(aligned_feat))

        # spatial attention pyramid (:189-213)
        attn = lrelu(self.spatial_attn1(aligned_feat))
        attn = lrelu(self.spatial_attn2(
            torch.cat([self.max_pool(attn), self.avg_pool(attn)], dim=1)))
        attn_level = lrelu(self.spatial_attn_l1(attn))
        attn_level = lrelu(self.spatial_attn_l2(
            torch.cat([self.max_pool(attn_level),
                       self.avg_pool(attn_level)], dim=1)))
        attn_level = _up2(lrelu(self.spatial_attn_l3(attn_level)))

        attn = lrelu(self.spatial_attn3(attn)) + attn_level
        attn = _up2(lrelu(self.spatial_attn4(attn)))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(
            lrelu(self.spatial_attn_add1(attn)))
        attn = torch.sigmoid(attn)

        # after init, attn * 2 is about 1 (:212-213)
        return feat * attn * 2 + attn_add


@ARCH_REGISTRY.register()
class EDVR(nn.Module):
    """EDVR top-level network (reference: edvr_arch.py:272-420).

    Input (b, t, c, h, w) LQ frames; output (b, c, 4h, 4w). With ``hr_in``
    the frames are HR (h, w multiples of 16), the pyramid starts at h/4 and
    the output is (b, c, h, w) with the centre frame itself as the base.
    ``with_predeblur`` puts the pre-deblur pyramid and a 1x1 conv in place
    of ``conv_first``.
    """

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
                 deformable_groups=8, num_extract_block=5,
                 num_reconstruct_block=10, center_frame_idx=None,
                 hr_in=False, with_predeblur=False, with_tsa=True,
                 align_variant='dcn'):
        super().__init__()
        if hr_in and not with_predeblur:
            # the stride convs that take an HR input to the LR grid are
            # the pre-deblur module's; without it the reference's and the
            # JAX package's forwards fail on the shapes
            raise ValueError('hr_in needs with_predeblur')
        nf = num_feat
        self.center_frame_idx = (num_frame // 2 if center_frame_idx is None
                                 else center_frame_idx)
        self.hr_in = hr_in
        self.with_predeblur = with_predeblur
        self.with_tsa = with_tsa

        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch=num_in_ch,
                                             num_feat=nf, hr_in=hr_in)
            self.conv_1x1 = nn.Conv2d(nf, nf, 1, 1)
        else:
            self.conv_first = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        self.feature_extraction = make_layer(
            ResidualBlockNoBN, num_extract_block, num_feat=nf)
        self.conv_l2_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l2_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_l3_1 = nn.Conv2d(nf, nf, 3, 2, 1)
        self.conv_l3_2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlignment(num_feat=nf,
                                      deformable_groups=deformable_groups,
                                      align_variant=align_variant)
        if with_tsa:
            self.fusion = TSAFusion(num_feat=nf, num_frame=num_frame,
                                    center_frame_idx=self.center_frame_idx)
        else:
            self.fusion = nn.Conv2d(num_frame * nf, nf, 1, 1)
        self.reconstruction = make_layer(
            ResidualBlockNoBN, num_reconstruct_block, num_feat=nf)
        self.upconv1 = nn.Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = nn.Conv2d(nf, 64 * 4, 3, 1, 1)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, num_out_ch, 3, 1, 1)

    def extract_pyramid(self, xf):
        """Per-frame L1/L2/L3 features (reference: edvr_arch.py:376-388) of
        (n, c, h, w) frames: (n, nf, h, w), (n, nf, h/2, w/2), (n, nf, h/4,
        w/4); with ``hr_in`` L1 is h/4 x w/4."""
        if self.with_predeblur:
            feat_l1 = self.conv_1x1(self.predeblur(xf))
        else:
            feat_l1 = lrelu(self.conv_first(xf))
        feat_l1 = self.feature_extraction(feat_l1)
        feat_l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(feat_l2))))
        return feat_l1, feat_l2, feat_l3

    def fuse_reconstruct(self, aligned, x_center):
        """Fusion (TSA or 1x1), the reconstruction trunk and the upsampling
        tail plus the base (reference: edvr_arch.py:405-419). ``aligned``
        is (b, t, nf, h, w); ``x_center`` the (b, c, h, w) LQ centre frame,
        the HR one with ``hr_in``."""
        b, t, nf, h, w = aligned.shape
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.reshape(b, t * nf, h, w))

        out = self.reconstruction(feat)
        out = lrelu(self.pixel_shuffle(self.upconv1(out)))
        out = lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = lrelu(self.conv_hr(out))
        out = self.conv_last(out)
        if self.hr_in:
            base = x_center
        else:
            base = F.interpolate(x_center, scale_factor=4, mode='bilinear',
                                 align_corners=False)
        return out + base

    def _align(self, nbr, ref, b, t):
        """One PCD call over all ``b * t`` frames, the reference pyramid
        tiled across them (``edvr_tpu/archs/edvr_arch.py:379-391``)."""
        aligned = self.pcd_align(nbr, ref)
        return aligned.view(b, t, *aligned.shape[1:])

    def restore_windows(self, pyr, clip, idx):
        """Restore (B, c, 4h, 4w) frames from a clip pyramid (pyramid-mode
        clip evaluation): ``pyr`` is the clip's (T, nf, ...) L1/L2/L3,
        ``clip`` its (T, c, h, w) frames, ``idx`` a (B, t) long tensor of
        window indices whose column ``center_frame_idx`` is the output
        frame."""
        B, t = idx.shape
        dtype = clip.dtype
        center = idx[:, self.center_frame_idx]
        nbr = [f.index_select(0, idx.reshape(-1)).to(dtype) for f in pyr]
        ref = [f.index_select(0, center.repeat_interleave(t)).to(dtype)
               for f in pyr]
        return self.fuse_reconstruct(self._align(nbr, ref, B, t),
                                     clip.index_select(0, center))

    def forward(self, x):
        b, t, c, h, w = x.shape
        mult = 16 if self.hr_in else 4
        if h % mult or w % mult:
            raise ValueError(f'The height and width must be multiples of '
                             f'{mult}, got {h}x{w}')
        x_center = x[:, self.center_frame_idx].contiguous()

        # per-frame pyramid with frames folded into the batch
        feats = [f.view(b, t, *f.shape[1:]) for f in
                 self.extract_pyramid(x.view(-1, c, h, w))]
        nbr = [f.reshape(b * t, *f.shape[2:]) for f in feats]
        ref = [f[:, self.center_frame_idx:self.center_frame_idx + 1]
               .expand(-1, t, -1, -1, -1).reshape(b * t, *f.shape[2:])
               for f in feats]
        return self.fuse_reconstruct(self._align(nbr, ref, b, t), x_center)


def clip_window_indices(num_frames_clip: int, num_frame: int,
                        padding: str = 'reflection_circle') -> np.ndarray:
    """(T, t) sliding-window index table for whole-clip evaluation, the
    per-frame windows of the reference's VideoTestDataset."""
    return np.asarray([
        generate_frame_indices(i, num_frames_clip, num_frame, padding)
        for i in range(num_frames_clip)
    ], dtype=np.int64)


def make_clip_restore_fn(model: EDVR, win_batch: int = 1, store_dtype=None,
                         mode: str = 'window'):
    """Whole-clip EDVR evaluation
    (``edvr_tpu/archs/edvr_arch.py:409-489``).

    Returns ``fn(clip, idx) -> (T, c, 4h, 4w)`` where ``clip`` is a
    (T, c, h, w) tensor on the model's device and ``idx`` the (T, t) table
    from :func:`clip_window_indices`. Windows are restored ``win_batch`` at
    a time, the loop that the JAX package runs as a ``lax.scan``; the last
    step is padded with copies of the last window, whose outputs are
    dropped.

    ``mode``:

    * ``'window'``: each step gathers windows of raw frames and runs the
      standard forward, re-extracting each frame's pyramid per window as
      the reference protocol does;
    * ``'pyramid'``: the clip's L1/L2/L3 pyramid is computed once and held
      in ``store_dtype``; each step gathers windows of features
      (:meth:`EDVR.restore_windows`). The pyramid is extracted
      ``win_batch * t`` frames at a time (each frame's is its own), so the
      extraction's intermediates stay those of one step however long the
      clip.

    ``store_dtype`` defaults to float32, the JAX package's choice when the
    matmul precision is pinned to float32, as it is in the port (TF32 off).
    """
    if win_batch < 1:
        raise ValueError(f'win_batch must be >= 1, got {win_batch}')
    if mode not in ('window', 'pyramid'):
        raise ValueError(f'unknown clip mode {mode!r}')
    store_dtype = store_dtype or torch.float32

    @torch.no_grad()
    def fn(clip, idx):
        idx = torch.as_tensor(idx, dtype=torch.long, device=clip.device)
        T, t = idx.shape
        pad = -T % win_batch
        if pad:
            idx = torch.cat([idx, idx[-1:].expand(pad, t)])
        if mode == 'pyramid':
            step = win_batch * t
            chunks = [model.extract_pyramid(clip[s:s + step])
                      for s in range(0, clip.shape[0], step)]
            pyr = [torch.cat(level).to(store_dtype)
                   for level in zip(*chunks)]
            del chunks
        outs = []
        for s in range(0, idx.shape[0], win_batch):
            idx_b = idx[s:s + win_batch]
            if mode == 'pyramid':
                outs.append(model.restore_windows(pyr, clip, idx_b))
            else:
                wins = clip[idx_b.reshape(-1)].view(win_batch, t,
                                                    *clip.shape[1:])
                outs.append(model(wins))
        return torch.cat(outs)[:T]

    return fn
