"""Official third-party checkpoints into BasicSR naming, the port's copy of
``edvr_tpu/convert/official.py:20-318`` (reference:
scripts/model_conversion/convert_models.py, convert_stylegan.py) for the
architectures the port has: EDVR, EDSR, RCAN, ESRGAN (RRDBNet), DUF's
16-layer model, rosinality's stylegan2-pytorch generator and
discriminator, and DFDNet. Other families' remaps come with their
architectures.

    python -m edvr_tpu_torch.convert.official --source EDVR \\
        --pth EDVR_official.pth --out net_g.pth
    python -m edvr_tpu_torch.convert.official --source EDSR --num_block 32 \\
        --pth EDSR_Lx4_official.pth --out net_g.pth
    python -m edvr_tpu_torch.convert.official --source DUF16 \\
        --pth DUF_x4_16L_official.pth --out net_g.pth
    python -m edvr_tpu_torch.convert.official --source StyleGAN2G \\
        --param_key g_ema --pth stylegan2-ffhq-config-f.pth --out net_g.pth
    python -m edvr_tpu_torch.convert.official --source DFDNet \\
        --pth DFDNet_official.pth --out DFDNet.pth

writes a BasicSR ``.pth`` (the state dict under ``params``) that
``edvr_tpu_torch.convert.load_state_dict_file`` and the CLIs'
``pretrain_network_g`` read, and reports the official keys no rule
renames.

Each remap returns (renamed_dict, unmatched_keys).
"""

from __future__ import annotations

import argparse
import math
import re
import sys


def _apply(state, rules, passthrough=()):
    """Rename keys by the first matching (regex, template) rule.

    Template may be a string with backrefs or a callable(match)->str.
    Keys matching a passthrough prefix are kept verbatim. Returns
    (renamed, unmatched).
    """
    out, unmatched = {}, []
    for k, v in state.items():
        if any(k.startswith(p) for p in passthrough):
            out[k] = v
            continue
        for pat, repl in rules:
            m = re.match(pat, k)
            if m:
                out[repl(m) if callable(repl) else m.expand(repl)] = v
                break
        else:
            unmatched.append(k)
    return out, unmatched


def edvr_to_official(k):
    """BasicSR EDVR key -> original-EDVR-repo key, the inverse of
    :func:`remap_edvr` (reference convert_models.py:16-106 elif chain,
    forward direction).

    Kept as an independent elif chain (no shared rule table with
    remap_edvr), so a round trip cross-checks two separate transcriptions
    of the reference mapping.
    """
    if 'predeblur.stride_conv_hr1' in k:
        return k.replace('predeblur.stride_conv_hr1',
                         'pre_deblur.conv_first_2')
    if 'predeblur.stride_conv_hr2' in k:
        return k.replace('predeblur.stride_conv_hr2',
                         'pre_deblur.conv_first_3')
    if 'predeblur.conv_first' in k:
        return k.replace('predeblur.conv_first', 'pre_deblur.conv_first_1')
    if 'predeblur.stride_conv_l2' in k:
        return k.replace('predeblur.stride_conv_l2',
                         'pre_deblur.deblur_L2_conv')
    if 'predeblur.stride_conv_l3' in k:
        return k.replace('predeblur.stride_conv_l3',
                         'pre_deblur.deblur_L3_conv')
    if 'predeblur.resblock_l3' in k:
        return k.replace('predeblur.resblock_l3', 'pre_deblur.RB_L3_1')
    if 'predeblur.resblock_l2' in k:
        return k.replace('predeblur.resblock_l', 'pre_deblur.RB_L')
    if 'predeblur.resblock_l1' in k:
        a, b, c, d, e = k.split('.')
        return f'pre_deblur.RB_L1_{int(c) + 1}.{d}.{e}'
    if 'conv_l2' in k:
        return k.replace('conv_l2_', 'fea_L2_conv')
    if 'conv_l3' in k:
        return k.replace('conv_l3_', 'fea_L3_conv')
    if 'pcd_align.dcn_pack' in k:
        idx = k.split('.l')[1].split('.')[0]
        name = k.split('.l')[1].split('.')[1]
        if 'conv_offset' in k:
            name = name.replace('conv_offset', 'conv_offset_mask')
            wb = k.split('.l')[1].split('.')[2]
            return f'pcd_align.L{idx}_dcnpack.{name}.{wb}'
        return f'pcd_align.L{idx}_dcnpack.{name}'
    if 'pcd_align.offset_conv' in k:
        a, b, c, d = k.split('.')
        idx = b.split('conv')[1]
        level = c.split('l')[1]
        return f'pcd_align.L{level}_offset_conv{idx}.{d}'
    if 'pcd_align.feat_conv' in k:
        a, b, c, d = k.split('.')
        level = c.split('l')[1]
        return f'pcd_align.L{level}_fea_conv.{d}'
    if 'pcd_align.cas_dcnpack' in k:
        return k.replace('conv_offset', 'conv_offset_mask')
    if ('conv_first' in k or 'feature_extraction' in k
            or 'pcd_align.cas_offset' in k or 'upconv' in k
            or 'conv_last' in k or 'conv_1x1' in k):
        return k
    if 'temporal_attn1' in k:
        return k.replace('fusion.temporal_attn1', 'tsa_fusion.tAtt_2')
    if 'temporal_attn2' in k:
        return k.replace('fusion.temporal_attn2', 'tsa_fusion.tAtt_1')
    if 'fusion.feat_fusion' in k:
        return k.replace('fusion.feat_fusion', 'tsa_fusion.fea_fusion')
    if 'fusion.spatial_attn_add' in k:
        return k.replace('fusion.spatial_attn_add', 'tsa_fusion.sAtt_add_')
    if 'fusion.spatial_attn_l' in k:
        return k.replace('fusion.spatial_attn_l', 'tsa_fusion.sAtt_L')
    if 'fusion.spatial_attn' in k:
        return k.replace('fusion.spatial_attn', 'tsa_fusion.sAtt_')
    if 'reconstruction' in k:
        return k.replace('reconstruction', 'recon_trunk')
    if 'conv_hr' in k:
        return k.replace('conv_hr', 'HRconv')
    if 'fusion' in k:
        return k.replace('fusion', 'tsa_fusion')
    return None


def remap_edvr(state):
    """Original-EDVR-repo naming -> BasicSR EDVR naming
    (convert_models.py:4-109, inverted)."""
    rules = [
        # predeblur (reference 'pre_deblur' module)
        (r'pre_deblur\.conv_first_1\.(.*)', r'predeblur.conv_first.\1'),
        (r'pre_deblur\.conv_first_2\.(.*)', r'predeblur.stride_conv_hr1.\1'),
        (r'pre_deblur\.conv_first_3\.(.*)', r'predeblur.stride_conv_hr2.\1'),
        (r'pre_deblur\.deblur_L2_conv\.(.*)', r'predeblur.stride_conv_l2.\1'),
        (r'pre_deblur\.deblur_L3_conv\.(.*)', r'predeblur.stride_conv_l3.\1'),
        (r'pre_deblur\.RB_L3_1\.(.*)', r'predeblur.resblock_l3.\1'),
        (r'pre_deblur\.RB_L2_(\d+)\.(.*)', r'predeblur.resblock_l2_\1.\2'),
        (r'pre_deblur\.RB_L1_(\d+)\.(.*)',
         lambda m: f'predeblur.resblock_l1.{int(m.group(1)) - 1}.'
                   f'{m.group(2)}'),
        # pyramid feature convs
        (r'fea_L2_conv(\d+)\.(.*)', r'conv_l2_\1.\2'),
        (r'fea_L3_conv(\d+)\.(.*)', r'conv_l3_\1.\2'),
        # PCD alignment
        (r'pcd_align\.L(\d)_dcnpack\.conv_offset_mask\.(.*)',
         r'pcd_align.dcn_pack.l\1.conv_offset.\2'),
        (r'pcd_align\.L(\d)_dcnpack\.(.*)', r'pcd_align.dcn_pack.l\1.\2'),
        (r'pcd_align\.L(\d)_offset_conv(\d)\.(.*)',
         r'pcd_align.offset_conv\2.l\1.\3'),
        (r'pcd_align\.L(\d)_fea_conv\.(.*)', r'pcd_align.feat_conv.l\1.\2'),
        (r'pcd_align\.cas_dcnpack\.conv_offset_mask\.(.*)',
         r'pcd_align.cas_dcnpack.conv_offset.\1'),
        (r'pcd_align\.cas_dcnpack\.(.*)', r'pcd_align.cas_dcnpack.\1'),
        # TSA fusion (note tAtt_2 <-> attn1 / tAtt_1 <-> attn2 swap)
        (r'tsa_fusion\.tAtt_2\.(.*)', r'fusion.temporal_attn1.\1'),
        (r'tsa_fusion\.tAtt_1\.(.*)', r'fusion.temporal_attn2.\1'),
        (r'tsa_fusion\.fea_fusion\.(.*)', r'fusion.feat_fusion.\1'),
        (r'tsa_fusion\.sAtt_add_(\d)\.(.*)', r'fusion.spatial_attn_add\1.\2'),
        (r'tsa_fusion\.sAtt_L(\d)\.(.*)', r'fusion.spatial_attn_l\1.\2'),
        (r'tsa_fusion\.sAtt_(\d)\.(.*)', r'fusion.spatial_attn\1.\2'),
        # woTSA models name the 1x1 fusion conv 'tsa_fusion' upstream
        (r'tsa_fusion\.(.*)', r'fusion.\1'),
        (r'recon_trunk\.(.*)', r'reconstruction.\1'),
        (r'HRconv\.(.*)', r'conv_hr.\1'),
    ]
    passthrough = ('conv_first.', 'feature_extraction.',
                   'pcd_align.cas_offset', 'upconv', 'conv_last.',
                   'conv_1x1.')
    return _apply(state, rules, passthrough)


def remap_edsr(state, num_block=16):
    """EDSR-PyTorch (thstkdgus35) naming -> BasicSR EDSR
    (convert_models.py:111-144, inverted; EDSR-L has 32 blocks)."""
    rules = [
        (r'head\.0\.(.*)', r'conv_first.\1'),
        (rf'body\.{num_block}\.(.*)', r'conv_after_body.\1'),
        (r'body\.(\d+)\.body\.0\.(.*)', r'body.\1.conv1.\2'),
        (r'body\.(\d+)\.body\.2\.(.*)', r'body.\1.conv2.\2'),
        (r'tail\.0\.0\.(.*)', r'upsample.0.\1'),
        (r'tail\.0\.2\.(.*)', r'upsample.2.\1'),
        (r'tail\.1\.(.*)', r'conv_last.\1'),
    ]
    return _apply(state, rules)


def remap_rcan(state, num_group=10, num_block=20):
    """yulunzhang/RCAN naming -> BasicSR RCAN
    (convert_models.py:147-181, inverted)."""
    rules = [
        (r'head\.0\.(.*)', r'conv_first.\1'),
        (rf'body\.{num_group}\.(.*)', r'conv_after_body.\1'),
        # channel attention: conv_du.<i> is attention.<i + 1> (the pool is
        # attention.0)
        (r'body\.(\d+)\.body\.(\d+)\.body\.(\d+)\.conv_du\.(\d+)\.(.*)',
         lambda m: f'body.{m.group(1)}.residual_group.{m.group(2)}.rcab.'
                   f'{m.group(3)}.attention.{int(m.group(4)) + 1}.'
                   f'{m.group(5)}'),
        (rf'body\.(\d+)\.body\.{num_block}\.(.*)', r'body.\1.conv.\2'),
        (r'body\.(\d+)\.body\.(\d+)\.body\.(\d+)\.(.*)',
         r'body.\1.residual_group.\2.rcab.\3.\4'),
        (r'tail\.0\.0\.(.*)', r'upsample.0.\1'),
        (r'tail\.0\.2\.(.*)', r'upsample.2.\1'),
        (r'tail\.1\.(.*)', r'conv_last.\1'),
    ]
    return _apply(state, rules)


def remap_esrgan(state):
    """Old official ESRGAN (RRDB_ESRGAN_x4.pth) naming -> BasicSR RRDBNet
    (convert_models.py:184-211, inverted)."""
    rules = [
        (r'RRDB_trunk\.(\d+)\.RDB(\d)\.(.*)', r'body.\1.rdb\2.\3'),
        (r'trunk_conv\.(.*)', r'conv_body.\1'),
        (r'upconv(\d)\.(.*)', r'conv_up\1.\2'),
        (r'HRconv\.(.*)', r'conv_hr.\1'),
    ]
    passthrough = ('conv_first.', 'conv_last.')
    return _apply(state, rules, passthrough)


def _deinterleave_duf_filters(v, scale):
    """DUF's residual-head rows (``conv3d_r2``'s weight and bias) from the
    official colour-fastest order (r0, g0, b0, r1, ...: TensorFlow's
    depth_to_space) into the colour-major order ``F.pixel_shuffle`` reads
    (all r^2 positions of R, then G, then B) (convert_models.py:378-396).
    Takes a tensor or an array and returns the same kind."""
    if v.shape[0] != 3 * scale ** 2:
        raise ValueError(f'conv3d_r2 leading dim {v.shape[0]} != '
                         f'3*scale^2 ({3 * scale ** 2})')
    n = v.shape[0]
    return v[[*range(0, n, 3), *range(1, n, 3), *range(2, n, 3)]]


def remap_duf_16l(state, scale=None):
    """Old official DUF 16-layer naming -> BasicSR DUF with
    adapt_official_weights=True (convert_models.py:287-376, inverted).

    ``dense_block_1``'s bn3d_{2i+1}, conv3d_{2i+1}, bn3d_{2i+2},
    conv3d_{2i+2} are children 0, 2, 3, 5 of ``dense_blocks.{i}``;
    ``dense_block_2``'s bn3d_{2t-1}, conv3d_{2t-1}, bn3d_{2t}, conv3d_{2t}
    those of ``temporal_reduce{t}``. With ``scale`` (the model's upscale
    factor) ``conv3d_r2``'s rows are also de-interleaved
    (:func:`_deinterleave_duf_filters`); a key-only round trip may omit
    it. The command always de-interleaves, with the factor that
    :func:`duf_scale` reads from the checkpoint.
    """
    def dense(which):
        def fn(m):
            block, idx = divmod(int(m.group(2)) - 1, 2)
            pos = {('bn3d', 0): 0, ('conv3d', 0): 2,
                   ('bn3d', 1): 3, ('conv3d', 1): 5}[(m.group(1), idx)]
            if which == 1:
                return (f'dense_block1.dense_blocks.{block}.{pos}.'
                        f'{m.group(3)}')
            return (f'dense_block2.temporal_reduce{block + 1}.{pos}.'
                    f'{m.group(3)}')
        return fn

    rules = [
        (r'conv3d_1\.(.*)', r'conv3d1.\1'),
        (r'conv3d_2\.(.*)', r'conv3d2.\1'),
        (r'dense_block_1\.(bn3d|conv3d)_(\d+)\.(.*)', dense(1)),
        (r'dense_block_2\.(bn3d|conv3d)_(\d+)\.(.*)', dense(2)),
        (r'bn3d_2\.(.*)', r'bn3d2.\1'),
    ]
    passthrough = ('conv3d_r1.', 'conv3d_r2.', 'conv3d_f1.', 'conv3d_f2.')
    renamed, unmatched = _apply(state, rules, passthrough)
    if scale is not None:
        for key in ('conv3d_r2.weight', 'conv3d_r2.bias'):
            if key in renamed:
                renamed[key] = _deinterleave_duf_filters(renamed[key], scale)
    return renamed, unmatched


def duf_scale(state):
    """DUF's upscale factor r, from the 3 r^2 rows of ``conv3d_r2``."""
    if 'conv3d_r2.weight' not in state:
        raise ValueError('not a DUF checkpoint: no conv3d_r2.weight')
    rows = state['conv3d_r2.weight'].shape[0]
    r = round(math.sqrt(rows / 3))
    if r < 1 or rows != 3 * r * r:
        raise ValueError(f'conv3d_r2 has {rows} rows, not 3*r^2 for any '
                         'upscale factor r')
    return r


def remap_stylegan2_g(state):
    """rosinality stylegan2-pytorch generator -> BasicSR StyleGAN2Generator
    (convert_stylegan.py:7-48, inverted)."""
    rules = [
        (r'style\.(.*)', r'style_mlp.\1'),
        (r'input\.input$', r'constant_input.weight'),
        (r'conv1\.conv\.(.*)', r'style_conv1.modulated_conv.\1'),
        (r'conv1\.noise\.weight$', r'style_conv1.weight'),
        (r'conv1\.(.*)', r'style_conv1.\1'),
        (r'convs\.(\d+)\.conv\.(.*)', r'style_convs.\1.modulated_conv.\2'),
        (r'convs\.(\d+)\.noise\.weight$', r'style_convs.\1.weight'),
        (r'convs\.(\d+)\.(.*)', r'style_convs.\1.\2'),
        (r'to_rgb1\.conv\.(.*)', r'to_rgb1.modulated_conv.\1'),
        (r'to_rgbs\.(\d+)\.conv\.(.*)', r'to_rgbs.\1.modulated_conv.\2'),
        (r'noises\.noise_(\d+)$', r'noises.noise\1'),
        # the reference's identity else-branch spelled out, so that unknown
        # official keys surface in `unmatched`: to_rgb biases and the fixed
        # upfirdn smoothing kernels keep their names
        (r'(to_rgb1\.bias)$', r'\1'),
        (r'(to_rgbs\.\d+\.bias)$', r'\1'),
        (r'(to_rgb1\.upsample\.kernel)$', r'\1'),
        (r'(to_rgbs\.\d+\.upsample\.kernel)$', r'\1'),
        (r'(convs\.\d+\.conv\.blur\.kernel)$', r'\1'),
        (r'(conv1\.conv\.blur\.kernel)$', r'\1'),
    ]
    return _apply(state, rules)


def remap_stylegan2_d(state):
    """rosinality stylegan2-pytorch discriminator -> BasicSR
    StyleGAN2Discriminator (convert_stylegan.py:51-68, inverted)."""
    rules = [(r'convs\.(.*)', r'conv_body.\1')]
    passthrough = ('final_conv.', 'final_linear.')
    return _apply(state, rules, passthrough)


def remap_dfdnet(state, vgg_names=None):
    """csxmli2016's official DFDNet naming -> BasicSR DFDNet
    (convert_dfdnet.py:7-65, inverted; the rules of
    ``edvr_tpu/convert/official.py::remap_dfdnet``). ``vgg_names`` (default
    vgg19's, ``archs.vgg_arch.NAMES``) names torchvision's feature
    indices. The spectral norms stay as they are (``weight_orig``, ``_u``,
    ``_v``): ``convert.fold_spectral_norm`` folds them when the checkpoint
    is read."""
    if vgg_names is None:
        from edvr_tpu_torch.archs.vgg_arch import NAMES
        vgg_names = NAMES['vgg19']

    def vgg(m):
        return (f'vgg_extractor.vgg_net.{vgg_names[int(m.group(1))]}.'
                f'{m.group(2)}')

    rules = [
        (r'VggExtract\.RGB_mean$', r'vgg_extractor.mean'),
        (r'VggExtract\.RGB_std$', r'vgg_extractor.std'),
        (r'VggExtract\.model\.features\.(\d+)\.(.*)', vgg),
        (r'le\.(.*)', r'attn_blocks.left_eye.\1'),
        (r're\.(.*)', r'attn_blocks.right_eye.\1'),
        (r'no\.(.*)', r'attn_blocks.nose.\1'),
        (r'mo\.(.*)', r'attn_blocks.mouth.\1'),
        (r'MSDilate\.conv(\d)\.(.*)',
         lambda m: f'multi_scale_dilation.conv_blocks.'
                   f'{int(m.group(1)) - 1}.{m.group(2)}'),
        (r'MSDilate\.convi\.(.*)', r'multi_scale_dilation.conv_fusion.\1'),
        (r'up4\.Model\.(.*)', r'upsample4.body.\1'),
        (r'up(\d)\.ScaleModel1\.(.*)', r'upsample\1.scale_block.\2'),
        (r'up(\d)\.ShiftModel1\.(.*)', r'upsample\1.shift_block.\2'),
        (r'up(\d)\.(.*)', r'upsample\1.\2'),
    ]
    return _apply(state, rules)


REMAPPERS = {'EDVR': remap_edvr, 'EDSR': remap_edsr, 'RCAN': remap_rcan,
             'ESRGAN': remap_esrgan, 'RRDBNet': remap_esrgan,
             'DUF16': remap_duf_16l, 'StyleGAN2G': remap_stylegan2_g,
             'StyleGAN2D': remap_stylegan2_d, 'DFDNet': remap_dfdnet}
# the depth arguments each family's remap takes
_DEPTH_ARGS = {'EDSR': ('num_block',), 'RCAN': ('num_group', 'num_block')}


def main(args=None):
    import torch

    from edvr_tpu_torch.convert import load_state_dict_file

    parser = argparse.ArgumentParser(
        description='Rename an official checkpoint into a BasicSR .pth.')
    parser.add_argument('--source', required=True, choices=sorted(REMAPPERS),
                        help='official checkpoint family')
    parser.add_argument('--pth', required=True,
                        help='the official .pth (a state dict, or one '
                        'under --param_key)')
    parser.add_argument('--out', required=True,
                        help='the BasicSR .pth to write')
    parser.add_argument('--param_key', default=None,
                        help='sub-dict key in the official file')
    parser.add_argument('--num_block', type=int, default=None,
                        help='EDSR: residual blocks (16 M, 32 L); RCAN: '
                        'blocks per group (20)')
    parser.add_argument('--num_group', type=int, default=None,
                        help='RCAN: residual groups (10)')
    args = parser.parse_args(args)

    state = load_state_dict_file(args.pth, args.param_key)
    depth = {k: getattr(args, k) for k in _DEPTH_ARGS.get(args.source, ())
             if getattr(args, k) is not None}
    if args.source == 'DUF16':
        depth['scale'] = duf_scale(state)
    renamed, unmatched = REMAPPERS[args.source](state, **depth)
    if unmatched:
        print(f'WARNING: {len(unmatched)} official keys without a rename '
              f'rule: {unmatched}', file=sys.stderr)
    torch.save({'params': renamed}, args.out)
    print(f'wrote {len(renamed)} tensors to {args.out}')
    return renamed, unmatched


if __name__ == '__main__':
    main()
