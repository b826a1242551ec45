"""EDVR: video restoration with PCD deformable alignment and TSA fusion
(NCHW), the counterpart of ``edvr_tpu/archs/edvr_arch.py``.

Parameter names are BasicSR's (reference:
basicsr/models/archs/edvr_arch.py). As in the JAX package, the PCD
alignment runs once per window with the frames folded into the batch
(``edvr_tpu/archs/edvr_arch.py:379-391``) instead of the reference's
per-frame loop, so each window makes four DCN calls (L3, L2, L1 and the
cascade), each over all ``num_frame`` frames.

This slice ports the plain (no predeblur, LR input) EDVR and the
window-mode whole-clip evaluation.
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

    Input (b, t, c, h, w) LQ frames; output (b, c, 4h, 4w).
    """

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
                 deformable_groups=8, num_extract_block=5,
                 num_reconstruct_block=10, center_frame_idx=None,
                 hr_in=False, with_predeblur=False, with_tsa=True,
                 align_variant='dcn'):
        super().__init__()
        if hr_in or with_predeblur:
            raise NotImplementedError(
                'EDVR with hr_in or with_predeblur is not ported yet')
        nf = num_feat
        self.center_frame_idx = (num_frame // 2 if center_frame_idx is None
                                 else center_frame_idx)
        self.with_tsa = with_tsa

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

    def forward(self, x):
        b, t, c, h, w = x.shape
        if h % 4 or w % 4:
            raise ValueError(
                f'The height and width must be multiples of 4, got {h}x{w}')
        x_center = x[:, self.center_frame_idx].contiguous()

        # per-frame pyramid with frames folded into the batch
        feat_l1 = lrelu(self.conv_first(x.view(-1, c, h, w)))
        feat_l1 = self.feature_extraction(feat_l1)
        feat_l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(feat_l1))))
        feat_l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(feat_l2))))

        feats = [f.view(b, t, *f.shape[1:]) for f in
                 (feat_l1, feat_l2, feat_l3)]
        # one PCD call over all frames, the reference pyramid tiled
        # across them (edvr_tpu/archs/edvr_arch.py:379-391)
        nbr = [f.reshape(b * t, *f.shape[2:]) for f in feats]
        ref = [f[:, self.center_frame_idx:self.center_frame_idx + 1]
               .expand(-1, t, -1, -1, -1).reshape(b * t, *f.shape[2:])
               for f in feats]
        aligned = self.pcd_align(nbr, ref).view(b, t, -1, h, w)

        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.view(b, -1, h, w))

        out = self.reconstruction(feat)
        out = lrelu(self.pixel_shuffle(self.upconv1(out)))
        out = lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = lrelu(self.conv_hr(out))
        out = self.conv_last(out)
        base = F.interpolate(x_center, scale_factor=4, mode='bilinear',
                             align_corners=False)
        return out + base


def clip_window_indices(num_frames_clip: int, num_frame: int,
                        padding: str = 'reflection_circle') -> np.ndarray:
    """(T, t) sliding-window index table for whole-clip evaluation, the
    per-frame windows of the reference's VideoTestDataset."""
    return np.asarray([
        generate_frame_indices(i, num_frames_clip, num_frame, padding)
        for i in range(num_frames_clip)
    ], dtype=np.int64)


def make_clip_restore_fn(model: EDVR, win_batch: int = 1):
    """Whole-clip EDVR evaluation in window mode.

    Returns ``fn(clip, idx) -> (T, c, 4h, 4w)`` where ``clip`` is a
    (T, c, h, w) tensor on the model's device and ``idx`` the (T, t) table
    from :func:`clip_window_indices`. Windows of raw frames are restored
    ``win_batch`` at a time through the standard forward, the loop that the
    JAX package runs as a ``lax.scan``
    (``edvr_tpu/archs/edvr_arch.py:409-489``). Pyramid mode is not ported
    yet.
    """
    if win_batch < 1:
        raise ValueError(f'win_batch must be >= 1, got {win_batch}')

    @torch.no_grad()
    def fn(clip, idx):
        idx = torch.as_tensor(idx, dtype=torch.long, device=clip.device)
        t = idx.shape[1]
        outs = []
        for s in range(0, idx.shape[0], win_batch):
            idx_b = idx[s:s + win_batch]
            wins = clip[idx_b.reshape(-1)].view(idx_b.shape[0], t,
                                                *clip.shape[1:])
            outs.append(model(wins))
        return torch.cat(outs)

    return fn
