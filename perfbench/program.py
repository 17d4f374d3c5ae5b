"""How the benchmark configures the system under test, ``srgd_tpu_torch``
(the PyTorch port), from a configuration file: the port's ``Config`` with
the precision the CLI's ``--precision`` sets. The port is imported inside
the function."""

from __future__ import annotations


def apply_overrides(cfg_data: dict, overrides: dict | None) -> dict:
    """A copy of a configuration with ``overrides`` (sizes; the CPU tests'
    tiny nets) applied to both its YAML and its reference section."""
    import copy
    cfg = copy.deepcopy(cfg_data)
    for k, v in (overrides or {}).items():
        if k in cfg['reference'] or k == 'quant_min_channels':
            cfg['reference'][k] = v
        yaml_key = 'quantize_min_channels' if k == 'quant_min_channels' else k
        if yaml_key in cfg['yaml'] or k in cfg['reference']:
            cfg['yaml'][yaml_key] = v
    return cfg


def port_config(cfg_data: dict, **extra):
    """The port's ``Config`` of a configuration file, as ``infer`` and
    ``serve`` set it for the file's ``precision``; ``extra`` sets more
    fields (the sampler's)."""
    from srgd_tpu_torch.config import Config
    conf = Config(**cfg_data['yaml'])
    precision = cfg_data['precision']
    conf.compute_dtype = {'fp32': 'float32', 'bf16': 'bfloat16',
                          'int8': 'bfloat16'}[precision]
    if precision == 'int8':
        conf.quantize = 'w8a8'
        conf.quantize_min_channels = cfg_data['reference'][
            'quant_min_channels']
    else:
        conf.quantize = 'none'
    for k, v in extra.items():
        setattr(conf, k, v)
    return conf
