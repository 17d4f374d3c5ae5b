"""Inference CLI of the PyTorch port: the flag surface of ``srgd_tpu.infer``.

    python -m srgd_tpu_torch.infer -c conf.yaml -m ckpt.pth \\
        --input_dir IN --output_dir OUT [--test_label 0 --class_cond_scale 1.0
        --seed 71 --num_sample_steps 250 --precision bf16 --device cuda ...]

Kept from the reference CLI (docs/PARITY.md #1, divergences 10-11): per-image
re-seeding, the x4 bicubic PIL pre-upscale (any --interpolation value means
bicubic), skip-existing resume by output filename, the '.png' -> '_out.png'
rename, the x4 output-size assert, unreadable inputs skipped, and the
accepted-but-unused --backend flag.

Port additions: --device (default cuda; asking for cuda without a card
raises).

``--mesh D,M`` runs tile data parallelism over D x M ranks, one process per
device (``parallel.mesh``: spawned here, or started by ``torchrun``; NCCL
on the card, where D x M must equal the visible GPUs, gloo with
``--device cpu``). Each data rank samples its block of every grid parity's
tile chunks and the blocks are all-gathered, so the PNG is the one rank's
PNG bit for bit; the model axis replicates the weights and splits no work,
as in the JAX CLI. Rank 0 lists the pending inputs and is the only writer;
with ``--quant_calibrate`` it calibrates (or loads the cache) and sends the
scales to the other ranks.

``--precision int8`` is the JAX CLI's W8A8 path: bf16 compute with the
U-Net's convs at least ``--quantize_min_channels`` wide (512 by default)
run as int8 (``nn.quant``, the ``int8_conv`` kernel), with dynamic
activation scales, or static ones with ``--quant_calibrate``, recorded once
at start-up (``--quant_calibrate_per_time``: one set per noise level;
``--quant_cal_mode p<pct>``: a percentile estimator) and kept across runs in
``--quant_calibrate_cache F.npz`` when its fingerprint matches. fp32 and
bf16 clear a YAML's ``quantize``. ``yaml`` and ``PIL`` are imported only
where the CLI needs them. ``--use_pallas`` keeps the JAX CLI's name: it
switches the U-Net to the second kernel set (``conf.use_pallas_kernels``).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

import numpy as np
import torch

from srgd_tpu_torch.diffusion.base import GeneratorNoise

logger = logging.getLogger('srgd_tpu_torch')


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-c', '--conf', required=True, help='Path to config file')
    p.add_argument('-m', '--ckpt_path', type=str, required=True)
    p.add_argument('--input_dir', type=str, required=True)
    p.add_argument('--output_dir', type=str, required=True)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--num_sample_steps', type=int, default=250)
    p.add_argument('--interpolation', type=str, default='bicubic')
    p.add_argument('--cond_scale', type=float, default=1.0)
    p.add_argument('--class_cond_scale', type=float, default=1.0)
    p.add_argument('--guidance_start_steps', type=int, default=0)
    p.add_argument('--class_guidance_start_steps', type=int, default=0)
    p.add_argument('--generation_start_steps', type=int, default=0)
    p.add_argument('--start_index', type=int, default=0)
    p.add_argument('--end_index', type=int, default=None)
    p.add_argument('--test_label', type=int, default=None)
    p.add_argument('--no_amp', dest='amp', action='store_false')
    p.add_argument('--no_dpmpp_solver', dest='use_dpmpp_solver',
                   action='store_false')
    p.add_argument('--continuous_sampler', type=str, default=None,
                   choices=['ancestral', 'ddim', 'dpmpp'])
    p.add_argument('--ddim_eta', type=float, default=None,
                   help='stochasticity of --continuous_sampler ddim: 0 '
                        'deterministic, 1 the ancestral posterior variance')
    p.add_argument('--seed', type=int, default=71)
    p.add_argument('--backend', type=str, default='ddp')  # accepted, unused
    p.add_argument('--precision', type=str, default='fp32',
                   choices=['fp32', 'bf16', 'int8'],
                   help='int8: bf16 compute with W8A8 int8 U-Net convs, '
                        'dynamic activation scales unless --quant_calibrate')
    add_quant_args(p)
    p.add_argument('--deep_cache', type=int, default=0,
                   help='>1: DeepCache sampling, the U-Net deep half '
                        'recomputed only every Nth step (per grid parity '
                        'when tiled); 0/1 = exact')
    p.add_argument('--deep_cache_depth', type=int, default=2,
                   help='U-Net stage where the cached deep half starts '
                        '(1..n_stages-1)')
    p.add_argument('--deep_cache_schedule', type=str, default='',
                   help="refresh positions as COUNTxINTERVAL segments in "
                        "sampling order, e.g. '0.5x3/0.5x1'; '' = every "
                        "--deep_cache-th step")
    p.add_argument('--matmul_precision', type=str, default='default',
                   choices=['default', 'high', 'highest'])
    p.add_argument('--tile_size', type=int, default=256)
    p.add_argument('--exec_mode', type=str, default='host',
                   choices=['host', 'scan'],
                   help='accepted; the port always runs a Python step loop')
    p.add_argument('--use_pallas', action='store_true',
                   help='GroupNorm+SiLU and linear attention through the '
                        'groupnorm_silu and linear_attention_qkv kernels')
    p.add_argument('--mesh', type=str, default='')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device to run on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def add_quant_args(p) -> None:
    """The int8 knobs of ``srgd_tpu.infer`` and ``srgd_tpu.serve``, with their
    defaults; each acts only with ``--precision int8``."""
    p.add_argument('--quantize_min_channels', type=int, default=512,
                   help='quantize only the U-Net blocks this wide or wider')
    p.add_argument('--quantize_smooth_alpha', type=float, default=0.0,
                   help='>0: SmoothQuant per-input-channel smoothing with '
                        'this alpha')
    p.add_argument('--quant_calibrate_per_time', action='store_true',
                   help='with --quant_calibrate: one scale set per '
                        'calibration noise level, the nearest one per step')
    p.add_argument('--quant_cal_mode', type=str, default='max',
                   help="calibration scale estimator: 'max' or 'p<pct>' "
                        "(the |x| percentile, e.g. p99.9)")
    p.add_argument('--quant_calibrate', action='store_true',
                   help='record static activation scales once at start-up '
                        'instead of per-call dynamic ones')
    p.add_argument('--quant_calibrate_cache', type=str, default='',
                   help='with --quant_calibrate: .npz file keeping the '
                        'recorded scales; a start whose fingerprint matches '
                        'loads it and skips calibration, any mismatch '
                        'recalibrates and rewrites it')


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda but no CUDA device is available; '
                           'pass --device cpu to run on the CPU')
    return device


def try_open_image(image_path):
    from PIL import Image
    try:
        return Image.open(image_path).convert('RGB')
    except (IOError, SyntaxError):
        return None


def upscale_bicubic(image, scale: int = 4, interpolation: str = 'bicubic'):
    """PIL x{scale} pre-upscale; every interpolation value maps to bicubic."""
    from PIL import Image
    width, height = image.size
    return image.resize((width * scale, height * scale), resample=Image.BICUBIC)


class Sampler:
    """The tiled sampler with the CLI's options, re-seeded for every image.

    ``noise_for_seed(seed, device)`` makes each image's noise source
    (default: ``GeneratorNoise``). Under a ``parallel.mesh.Mesh`` every
    rank calls ``sample`` with the same arguments and gets the whole
    output."""

    def __init__(self, wrapper, opts: dict, device,
                 noise_for_seed=GeneratorNoise, mesh=None):
        self.wrapper, self.opts, self.device = wrapper, opts, device
        self.noise_for_seed = noise_for_seed
        self.mesh = mesh

    def sample(self, cond_np: np.ndarray, label, seed: int,
               guidance: dict | None = None) -> np.ndarray:
        """cond_np: (B, H, W, C) in [0, 1]; label: None, an int applied to
        every canvas, or a per-canvas (B,) array. ``guidance`` overrides
        ``cond_scale``, ``class_cond_scale`` and the ``*_start_steps`` for
        this call only. Returns (B, H, W, C) in [0, 1] as numpy."""
        o = {**self.opts, **(guidance or {})}
        cond = torch.from_numpy(np.ascontiguousarray(cond_np)).to(self.device)
        lab = None
        if label is not None:
            lab = torch.from_numpy(np.broadcast_to(
                np.asarray(label, np.int64).reshape(-1),
                (cond.shape[0],)).copy()).to(self.device)
        out = self.wrapper.tiled_sample(
            cond, lab, batch_size=o['batch_size'], tile_size=o['tile_size'],
            tile_stride=o['tile_stride'], cond_scale=o['cond_scale'],
            guidance_start_steps=o['guidance_start_steps'],
            class_cond_scale=o['class_cond_scale'],
            class_guidance_start_steps=o['class_guidance_start_steps'],
            generation_start_steps=o['generation_start_steps'],
            num_sample_steps=o['num_sample_steps'],
            noise=self.noise_for_seed(seed, self.device), mesh=self.mesh)
        return out.cpu().numpy()


def sr_target_image(image, sampler: Sampler, scale: int = 4, test_label=None,
                    interpolation: str = 'bicubic', seed: int = 71):
    """Super-resolve one PIL image."""
    from PIL import Image
    width, height = image.size
    upscaled = upscale_bicubic(image, scale, interpolation)
    cond = np.asarray(upscaled, dtype=np.float32)[None] / 255.0
    out = sampler.sample(cond, test_label, seed)[0]
    sr_img = Image.fromarray(np.clip(np.round(out * 255.0), 0, 255)
                             .astype(np.uint8))
    new_width, new_height = sr_img.size
    assert width * 4 == new_width
    assert height * 4 == new_height
    return sr_img


def pending_outputs(input_dir, output_dir, start_index=0, end_index=None,
                    verbose_skip=False):
    """(input_path, output_path) of the sorted inputs whose output does not
    exist yet; output names rewrite '.png' to '_out.png'. ``verbose_skip``
    prints the reference CLI's 'skip' for each existing output (the batch
    CLI's, not the polling daemon's)."""
    for filename in sorted(glob.glob(f'{input_dir}/*'))[start_index:end_index]:
        save_filename = os.path.basename(filename).replace('.png', '_out.png')
        save_path = os.path.join(output_dir, save_filename)
        if os.path.exists(save_path):
            if verbose_skip:
                print('skip')
            continue
        yield filename, save_path


def batch_sr_target_images(input_dir, output_dir, sampler: Sampler, scale=4,
                           test_label=None, start_index=0, end_index=None,
                           interpolation='bicubic', seed=71):
    """Super-resolve every pending input of ``input_dir`` into ``output_dir``.
    Under a mesh rank 0 lists the inputs and writes the outputs."""
    mesh = sampler.mesh
    writer = mesh is None or mesh.is_writer
    pending = None
    if writer:
        print(f'save images at: {output_dir}')
        os.makedirs(output_dir, exist_ok=True)
        pending = list(pending_outputs(input_dir, output_dir, start_index,
                                       end_index, verbose_skip=True))
    if mesh is not None:
        from srgd_tpu_torch.parallel.mesh import broadcast_object
        pending = broadcast_object(pending, mesh)
    for filename, save_path in pending:
        image = try_open_image(filename)
        if image is None:
            if writer:
                print('Invalid image or unable to open image:', filename)
            continue
        t0 = time.time()
        sr_img = sr_target_image(image, sampler, scale=scale,
                                 test_label=test_label,
                                 interpolation=interpolation, seed=seed)
        if not writer:
            continue
        sr_img.save(save_path)
        logger.info('%s -> %s (%.2f MPix in %.2fs)', filename, save_path,
                    sr_img.size[0] * sr_img.size[1] / 1e6, time.time() - t0)


def calibrate(args, conf, wrapper, cal_draws=None) -> None:
    """``--quant_calibrate``: load the cache when its fingerprint matches,
    else calibrate (tile batch min(batch_size, 4), draws from a generator
    seeded with ``--seed``, or ``cal_draws(seed, shape)`` -> (x, cond)) and
    write it."""
    from srgd_tpu_torch.nn import quant
    if args.quantize_smooth_alpha:
        logger.warning(
            'combining --quant_calibrate with --quantize_smooth_alpha '
            'measured worse than either alone in the JAX package (static '
            'per-tensor scales compound calibration drift); smoothing is '
            'meant for dynamic scales')
    per_time, cache = args.quant_calibrate_per_time, args.quant_calibrate_cache
    batch = min(args.batch_size, 4)
    fp = quant.calibration_fingerprint(
        conf, ckpt_path=args.ckpt_path, tile_size=args.tile_size,
        per_time=per_time, seed=args.seed, class_label=args.test_label,
        batch=batch)
    if cache and os.path.exists(cache) and \
            quant.load_calibration(cache, wrapper.net, fp) is not None:
        logger.info('loaded calibration cache %s (calibrate phase skipped)',
                    cache)
        return
    shape = (batch, args.tile_size, args.tile_size, 3)
    recorded = quant.calibrate_sampler(
        wrapper, generator=torch.Generator().manual_seed(args.seed),
        tile_size=args.tile_size, batch=batch, class_label=args.test_label,
        per_time=per_time,
        draws=None if cal_draws is None else cal_draws(args.seed, shape))
    if cache and recorded:
        quant.save_calibration(cache, wrapper.net, fp)
        logger.info('saved calibration cache %s', cache)


def build_sampler(args, noise_for_seed=GeneratorNoise,
                  cal_draws=None, mesh=None) -> Sampler:
    """Config + flags -> the model on ``args.device``, or on the rank's
    device of ``mesh`` (calibrated with ``--quant_calibrate``, by rank 0
    under a mesh) -> a ``Sampler``."""
    from srgd_tpu_torch.config import load_config
    from srgd_tpu_torch.factory import get_model
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if args.matmul_precision != 'default':
        # float32 products: 'highest' keeps full float32, 'high' allows TF32
        torch.set_float32_matmul_precision(args.matmul_precision)
        torch.backends.cudnn.allow_tf32 = args.matmul_precision == 'high'
    conf = load_config(args.conf)
    conf.num_sample_steps = args.num_sample_steps
    conf.ckpt_path = args.ckpt_path
    conf.use_dpmpp_solver = args.use_dpmpp_solver
    conf.compute_dtype = {'fp32': 'float32', 'bf16': 'bfloat16',
                          'int8': 'bfloat16'}[args.precision]
    if args.precision == 'int8':
        conf.quantize = 'w8a8'
        conf.quantize_min_channels = args.quantize_min_channels
        if args.quantize_smooth_alpha:
            conf.quantize_smooth_alpha = args.quantize_smooth_alpha
        if args.quant_cal_mode != 'max':
            conf.quantize_cal_mode = args.quant_cal_mode
    else:
        conf.quantize = 'none'  # --precision fp32/bf16 overrides the YAML
    conf.tile_size = args.tile_size
    conf.use_pallas_kernels = args.use_pallas
    if args.continuous_sampler:
        conf.continuous_sampler = args.continuous_sampler
    if args.ddim_eta is not None:
        conf.ddim_eta = args.ddim_eta
    if args.deep_cache:
        conf.deep_cache_interval = args.deep_cache
        conf.deep_cache_depth = args.deep_cache_depth
        conf.deep_cache_schedule = args.deep_cache_schedule
    wrapper, _ = get_model(conf, device=device)
    if args.precision == 'int8' and args.quant_calibrate:
        if mesh is None or mesh.is_writer:
            calibrate(args, conf, wrapper, cal_draws)
        if mesh is not None:
            from srgd_tpu_torch.nn import quant
            from srgd_tpu_torch.parallel.mesh import broadcast_object
            stats = broadcast_object(quant.recorded_stats(wrapper.net)
                                     if mesh.is_writer else None, mesh)
            if not mesh.is_writer and stats:
                quant.load_stats(wrapper.net, stats)
    opts = dict(batch_size=args.batch_size, tile_size=args.tile_size,
                tile_stride=conf.tile_stride or None,
                cond_scale=args.cond_scale,
                guidance_start_steps=args.guidance_start_steps,
                class_cond_scale=args.class_cond_scale,
                class_guidance_start_steps=args.class_guidance_start_steps,
                generation_start_steps=args.generation_start_steps,
                num_sample_steps=args.num_sample_steps, model=conf.model)
    return Sampler(wrapper, opts, device, noise_for_seed, mesh)


def run(args, sampler: Sampler) -> None:
    batch_sr_target_images(args.input_dir, args.output_dir, sampler, scale=4,
                           test_label=args.test_label,
                           start_index=args.start_index,
                           end_index=args.end_index,
                           interpolation=args.interpolation, seed=args.seed)


def log_config():
    """The CLIs' logging: INFO with timestamps, on every rank of a mesh."""
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(levelname)s %(message)s')


def _mesh_rank(mesh, args):
    """One rank of ``--mesh``."""
    log_config()
    sampler = build_sampler(args, mesh=mesh)
    if mesh.is_writer:
        print(args)
    run(args, sampler)


def main(argv=None):
    log_config()
    args = parse_args(argv)
    if args.mesh:
        from srgd_tpu_torch.parallel.mesh import launch, parse_shape
        launch(_mesh_rank, parse_shape(args.mesh),
               resolve_device(args.device).type, (args,))
        return
    sampler = build_sampler(args)
    print(args)
    run(args, sampler)


if __name__ == '__main__':
    main()
