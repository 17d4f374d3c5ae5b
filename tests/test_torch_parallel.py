"""The port's device mesh (``srgd_tpu_torch.parallel``) against
``srgd_tpu/parallel/mesh.py`` and against its own single rank.

Mirrors tests/test_parallel.py and tests/test_cli.py:129. The JAX side runs
in this process on the 8 virtual CPU devices of tests/conftest.py; the
port's side runs spawned gloo ranks (``parallel.mesh.launch``: start method
spawn, a ``file://`` store in a directory under the test's tmp path, a 60 s
process-group timeout, a join deadline that kills leftover ranks, one
PyTorch thread per rank). The rank bodies live in
tests/test_torch_mesh_ranks.py, which imports no JAX.

Tiled sampling splits the tile chunks over the data ranks and gathers them
back, and every chunk keeps the batch it has at world 1, so worlds 2 and 4
are held to world 1 bit for bit; the port at world 2 is held to JAX's
``SamplerCache`` on a (2, 1) mesh at the sampler bar (max error < 5e-4,
PSNR > 60 dB). The CLI and the daemon under a mesh are in
tests/test_torch_parallel_cli.py, training in
tests/test_torch_parallel_train.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srgd_tpu_torch.parallel import mesh as tmesh
from tests import test_torch_mesh_ranks as ranks

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

run_world = ranks.run_world


# ---------------------------------------------------------------------------
# make_mesh and the sharding rule
# ---------------------------------------------------------------------------

def test_make_mesh_shapes(tmp_path):
    assert tmesh.check_shape(None, 8) == (8, 1)
    assert tmesh.check_shape((4, 2), 8) == (4, 2)
    with pytest.raises(AssertionError, match=r'mesh \(3, 2\) != 8 devices'):
        tmesh.check_shape((3, 2), 8)
    assert tmesh.parse_shape('2,1') == (2, 1) and tmesh.parse_shape('') is None
    # a one-rank mesh in this process
    facts = run_world(ranks.sample_rank, None, ([],), tmp_path)['facts']
    assert facts == dict(shape=(1, 1), data=0, model=0, default=(1, 1),
                         from_config=(1, 1),
                         error='mesh (3, 2) != 1 devices')


def test_spawned_ranks_take_the_launching_settings(tmp_path):
    """A spawned rank computes with the launching process's float32
    precision settings (a spawned process would start from torch's
    defaults), and its mesh carries the process group's timeout."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision('high')
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = run_world(ranks.flags_rank, (2, 1), (), tmp_path, timeout_s=45)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert got == (('high', False), 45)


def test_partition_params_rules():
    """tests/test_parallel.py's case in the port's layout: an OIHW conv
    weight shards on dim 0, its bias, a GroupNorm scale and a kernel with
    too few output channels replicate."""
    from torch.distributed.tensor import Replicate, Shard
    params = {'conv.weight': torch.zeros(16, 8, 3, 3),
              'conv.bias': torch.zeros(16),
              'block1.norm.weight': torch.zeros(16),
              'tiny.weight': torch.zeros(2, 4)}
    specs = tmesh.partition_params(params, 2)
    assert specs == {'conv.weight': (Shard(0),), 'conv.bias': (Replicate(),),
                     'block1.norm.weight': (Replicate(),),
                     'tiny.weight': (Replicate(),)}
    assert all(s == (Replicate(),)
               for s in tmesh.partition_params(params, 1).values())


def test_partition_params_real_net_matches_jax():
    """On a real tiny SRUnet (4 classes, so the class embedding has an
    output dim that divides), the port shards exactly the parameters JAX's
    ``partition_params`` shards, mapped through the converter: each JAX leaf
    is tagged with its index and read back from the converted state dict.
    The converter's mapping also gives ``checkpoint.jax_leaf``."""
    from srgd_tpu.nn.unet import SRUnet as JaxUnet
    from srgd_tpu.parallel.mesh import make_mesh, partition_params
    from srgd_tpu_torch.checkpoint import (flax_to_torch_unet_state_dict,
                                           jax_leaf)
    from srgd_tpu_torch.nn.unet import SRUnet
    kw = dict(dim=8, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
              num_classes=4)
    params = JaxUnet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
        class_label=jnp.zeros((1,), jnp.int32))['params']
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        tree, [np.full(v.shape, i, np.float32)
               for i, (_, v) in enumerate(leaves)])
    source = {k: int(v.flat[0]) for k, v in
              flax_to_torch_unet_state_dict(tagged).items()}
    specs = jax.tree_util.tree_leaves(
        partition_params({'params': params}, make_mesh((4, 2))))
    jax_sharded = {k for k, i in source.items() if 'model' in specs[i].spec}

    net = SRUnet(**kw)
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(source)
    for k, i in source.items():
        assert jax_leaf(k) == leaves[i][0][-1].key, k
    assert set(tmesh.sharded_names(named, 2)) == jax_sharded
    assert 'class_mlp.0.weight' not in jax_sharded      # a JAX embedding
    assert named['class_mlp.0.weight'].shape[0] % 2 == 0


# ---------------------------------------------------------------------------
# Tiled sampling: worlds 2 and 4 against world 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    names = list(ranks.CASES)
    out = {1: {n: ranks.sample_case(n) for n in names}}
    for world in (2, 4):
        out[world] = run_world(ranks.sample_rank, (world, 1), (names,),
                               tmp_path_factory.mktemp(f'world{world}'))
    return out


@pytest.mark.parametrize('case', sorted(ranks.CASES))
@pytest.mark.parametrize('world', [2, 4])
def test_tiled_sampling_is_bit_equal_to_one_rank(worlds, world, case):
    """A fake net (aligned and overlapping stride), a real SRUnet in each
    family (continuous ancestral with class CFG, dpmpp, gaussian DDIM,
    elucidated Heun) and DeepCache dc2:2 on a 3-stage net: the canvas
    world N gives is world 1's, bit for bit."""
    want, got = worlds[1][case], worlds[world][case]
    assert np.isfinite(want).all() and want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    facts = worlds[world]['facts']
    assert facts['shape'] == facts['default'] == facts['from_config'] == (
        world, 1)
    assert facts['error'] == f'mesh (3, 2) != {world} devices'


def test_mesh_sampling_matches_jax_sampler_cache(tmp_path):
    """The port at world 2 against JAX's ``SamplerCache`` on a (2, 1) mesh:
    the same weights, the JAX key schedule's noise (recorded here and
    replayed in the ranks), class CFG on a 64 px canvas, tile 32, tile
    batch 2: the sampler bar, and world 2 equals the port's world 1."""
    from srgd_tpu.diffusion.continuous import ContinuousDiffusion as JaxCD
    from srgd_tpu.infer import SamplerCache
    from srgd_tpu.nn.unet import SRUnet as JaxUnet
    from srgd_tpu.parallel.mesh import make_mesh
    from srgd_tpu_torch.checkpoint import state_dict_from_jax
    from tests.test_torch_sampler import JaxKeyNoise, assert_golden
    kw = dict(dim=8, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
              num_classes=3)
    params = JaxUnet(**kw).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
        class_label=jnp.zeros((1,), jnp.int32))
    cond = np.random.default_rng(5).uniform(
        size=(1, 64, 64, 3)).astype(np.float32)
    label, seed = np.asarray([2]), 11
    skw = dict(tile_size=32, batch_size=2, class_cond_scale=2.0,
               num_sample_steps=3)
    opts = dict(exec_mode='host', tile_stride=None, cond_scale=1.0,
                guidance_start_steps=0, class_guidance_start_steps=0,
                generation_start_steps=0, **skw)
    want = SamplerCache(JaxCD(net=JaxUnet(**kw), image_size=32), params, opts,
                        mesh=make_mesh((2, 1), devices=jax.devices()[:2])
                        ).sample(cond, label, seed)

    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    rec = ranks.Recorder(JaxKeyNoise(jax.random.PRNGKey(seed)))
    one = ranks.jax_weights_rank(None, sd, kw, cond, label, rec, skw)
    two = run_world(ranks.jax_weights_rank, (2, 1),
                    (sd, kw, cond, label, rec.draws, skw), tmp_path)
    np.testing.assert_array_equal(two, one)
    assert_golden(two, np.asarray(want))
