"""Configuration: dataclass defaults overridden by a YAML file.

The port's own copy of ``srgd_tpu/config.py`` (``Config``, ``load_config``):
the same field names and defaults, which are the reference's API surface, so
every YAML of the repository loads unchanged, and an unknown key is a
TypeError as with ``Config(**yaml)``. Fields the port does not act on yet are
carried all the same; the entry points raise for the ones that would change
the result (``srgd_tpu_torch/nn/unet.py``, ``srgd_tpu_torch/infer.py``).
tests/test_torch_hygiene.py holds this copy to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields


@dataclass
class Config:
    save_dir: str = 'srgd'
    prefix: str = 'conditional_continuous_linear'

    base_dir: str = './input/'
    dataset_name: str = 'cropped_df2kost_400x400_overlap200'

    # gaussian / elucidated / continuous and conditional_* variants
    model: str = 'continuous'

    cond_drop_prob: float = 0.1
    cond_scale: float = 1.

    num_classes: int = 3
    conditional_task_type: str = 'realsr_denoise_sr'
    class_cond_drop_prob: float = 0.1
    class_cond_scale: float = 1.
    test_label: int = 0

    guidance_start_steps: int = 0
    class_guidance_start_steps: int = 0
    generation_start_steps: int = 0

    # discrete Gaussian diffusion family
    objective: str = 'pred_noise'
    beta_schedule: str = 'linear'
    timesteps: int = 1000
    sampling_timesteps: int = 250
    offset_noise_strength: float = 0.

    loss_type: str = 'l2'

    # EDM (elucidated) family
    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80
    sigma_data: float = 0.5
    rho: float = 7
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80
    S_tmin: float = 0.05
    S_tmax: float = 50
    S_noise: float = 1.003
    use_dpmpp_solver: bool = True

    # continuous-time family
    noise_schedule: str = 'linear'
    clip_sample_denoised: bool = True
    learned_schedule_net_hidden_dim: int = 1024
    learned_noise_schedule_frac_gradient: float = 1.

    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5

    val_num_sample_steps: int = 32

    n_fold: int = 10
    train_fold: str = '0'

    skip_sample: bool = False
    skip_val: bool = False

    validation_ratio: float = 0.5

    val_realsrv3: bool = False
    val_drealsr: bool = False
    val_realsrv3_scale: int = 4
    val_drealsr_scale: int = 4

    image_size: int = 128
    crop_size: int = 256
    hr_image_size: int = 256
    lr_image_size: int = 128
    crop_rate: int = 2

    scale_size: int = 256

    crop_size_limit: bool = False

    pixel_shuffle_upsample: bool = True

    batch_size: int = 32

    sample_size: int = 16

    hflip: bool = False
    rotate: bool = False
    shuffle: bool = True

    torch_compile: bool = False

    seed: int = 71

    amp: bool = False
    amp_dtype: str = 'float16'

    # U-Net
    unet_dim: int = 64
    ddpm_unet_dim_mults: str = '1,2,4,8'
    full_attn: str = 'False,False,False,True'
    learned_variance: bool = False
    learned_sinusoidal_cond: bool = True
    learned_sinusoidal_dim: int = 32

    ema_decay: float = 0.995
    ema_device: str = 'cuda'

    flash_attn: bool = False  # full-attention blocks use kernels/attention.py

    ckpt_path: str = ''
    load_strict: bool = True

    # optimizer
    optimizer: str = 'adamw'
    lr: float = 1e-4
    min_lr: float = 1e-4
    weight_decay: float = 0.
    momentum: float = 0.9
    nesterov: bool = False
    amsgrad: bool = False
    madgrad_decoupled_decay: bool = True

    # scheduler
    epochs: int = 300
    warmup_epochs: int = 0
    warmup_lr_init: float = 1e-6
    plateau_mode: str = 'min'
    factor: float = 0.1
    patience: int = 4
    plateau_eps: float = 1e-8
    scheduler: str = 'cosine'
    cosine_interval_type: str = 'step'

    train_preprocess: str = 'randomcrop'
    valid_preprocess: str = 'centercrop'

    train_trans_mode: str = 'realesrgan'
    valid_trans_mode: str = 'simple'

    usm_sharpener: bool = False

    interpolation: str = 'BICUBIC'

    blur_prob: float = 0.5
    advance_blur_prob: float = 0.5
    gaussian_blur_prob: float = 0.5
    sinc_blur_prob: float = 0.5
    sinc_blur_factor_min: float = 0.9
    sinc_blur_factor_max: float = 1.1
    image_compression_prob: float = 0.5
    quality_lower: int = 50
    quality_upper: int = 100
    noise_prob: float = 0.5
    gauss_noise_prob: float = 0.5
    iso_noise_prob: float = 0.5
    multiplicative_noise_prob: float = 0.5

    train: bool = True
    test: bool = False
    debug: bool = False

    save_validation_sample: bool = False
    save_validation_hr_sample: bool = False

    save_every_epoch: bool = False

    test_target: str = 'best_loss'

    num_workers: int = 4
    device: str = 'cuda'
    pin_memory: bool = True
    model_dir: str = 'models'
    log_dir: str = 'logs'
    print_freq: int = 0

    # Additions of the JAX package, kept so that its YAMLs load unchanged
    # (absent from reference YAMLs; the defaults keep reference behaviour).
    compute_dtype: str = 'float32'    # float32 / bfloat16 U-Net compute
    param_dtype: str = 'float32'
    quantize: str = 'none'
    quantize_min_channels: int = 0
    quantize_smooth_alpha: float = 0.0
    quantize_cal_mode: str = 'max'
    use_pallas_kernels: bool = False  # opt-in: the groupnorm_silu and
                                      # linear_attention_qkv kernels
    fused_linattn: bool = True        # whole-block attention kernels
    mesh_shape: str = ''
    remat_unet: bool = False
    tile_size: int = 256
    tile_stride: int = 0              # 0 = tile_size
    continuous_sampler: str = 'ancestral'  # | 'ddim' | 'dpmpp'
    ddim_eta: float = 0.0             # 0 deterministic, 1 ancestral-equivalent
    deep_cache_interval: int = 0
    deep_cache_depth: int = 2
    deep_cache_schedule: str = ''
    lpips_weights_path: str = ''


def load_config(config_file) -> Config:
    """YAML keys override the dataclass defaults; unknown keys are a
    TypeError. YAML 1.1 reads bare scientific notation ('lr: 1e-4', the
    shipped YAML's spelling) as a string, so float and int fields coerce
    numeric strings after the load."""
    import yaml
    with open(config_file, 'r') as fp:
        opts = yaml.safe_load(fp)
    conf = Config(**opts)
    for f in dc_fields(Config):
        v = getattr(conf, f.name)
        if isinstance(v, str) and f.type in ('float', 'int', float, int):
            try:
                setattr(conf, f.name, float(v) if f.type in ('float', float)
                        else int(v))
            except ValueError:
                pass  # non-numeric strings are left for downstream validation
    return conf
