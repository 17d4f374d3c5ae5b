"""The port's training path against the JAX package's.

- Kernel gradients: ``linattn_block`` and ``attn_block`` (the port's
  ``autograd.Function``s) against ``jax.vjp`` of ``_xla_linattn_block`` /
  ``_xla_attn_block``, which is what the JAX ``custom_vjp`` backward
  computes, so no Pallas interpret mode is reached. float32: each
  gradient's ``max|d| <= 1e-4 * max|g_jax|``; bfloat16: ``<= 2e-2 *
  max|g_jax|``, the kernel tests' bf16 budget. The three kernels without a
  VJP raise the named error on ``backward()``.
- remat: the same loss and gradients, bit for bit.
- Optimizers, schedules and the EMA against optax over 5 steps on the same
  injected gradients: parameters and state within 1e-6 of each tensor's
  largest entry.

Weights come from JAX ``init`` through ``checkpoint.state_dict_from_jax``;
gradient and optimizer-state trees have the params' shape and go through
the same function. Tiny sizes (dim 8 or 16, mults 1,2, 16 px, batch 2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from srgd_tpu.config import Config as JaxConfig
from srgd_tpu.kernels.attn_block import _xla_attn_block
from srgd_tpu.kernels.linattn_block import _xla_linattn_block
from srgd_tpu.train import trainer as jtrainer
from srgd_tpu.train.ema import ema_update as jax_ema_update
from srgd_tpu.checkpoint.torch_convert import convert_unet_state_dict
from srgd_tpu.factory import build_wrapper as jax_build_wrapper
from srgd_tpu.nn.unet import build_unet_from_config as jax_build_unet
from srgd_tpu_torch.checkpoint import state_dict_from_jax
from srgd_tpu_torch.factory import build_wrapper
from srgd_tpu_torch.nn.unet import build_unet_from_config
from srgd_tpu_torch.config import Config
from srgd_tpu_torch.diffusion.base import GeneratorDraws
from srgd_tpu_torch.diffusion.continuous import ContinuousDiffusion
from srgd_tpu_torch.kernels import attention as at
from srgd_tpu_torch.kernels import attn_block as ab
from srgd_tpu_torch.kernels import groupnorm_silu as gs
from srgd_tpu_torch.kernels import linattn_block as lb
from srgd_tpu_torch.kernels import linear_attention as la
from srgd_tpu_torch.nn.unet import SRUnet
from srgd_tpu_torch.train import trainer
from srgd_tpu_torch.train.ema import ema_update

torch.set_num_threads(1)   # tiny sizes; the suite runs many workers at once

GRAD_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
OPT_RTOL = 1e-6
TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
JDT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}

# the JAX losses' ``jax.random.split(rng, n)`` keys, by the port's draw names
ROLES = {'continuous': ('t', 'noise', 'drop_cond', 'drop_class'),
         'gaussian': ('t', 'noise', 'offset', 'drop_cond', 'drop_class'),
         'elucidated': ('sigma', 'noise', 'drop_cond', 'drop_class')}


class JaxDraws:
    """A port draw source that replays the JAX loss's keys: the key of each
    role from ``split(rng, n)``, drawn as the JAX loss draws it."""

    def __init__(self, rng, family):
        self.keys = dict(zip(ROLES[family],
                             jax.random.split(rng, len(ROLES[family]))))

    def uniform(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.keys[name], tuple(shape), jnp.float32)))

    def normal(self, name, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            self.keys[name], tuple(shape), jnp.float32)))

    def randint(self, name, shape, high):
        return torch.from_numpy(np.array(jax.random.randint(
            self.keys[name], tuple(shape), 0, high))).long()


def assert_rel(got, want, rtol, what=''):
    """max|got - want| <= rtol * max|want| (and shapes agree)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)
    return err / max(scale, 1e-30)


def assert_tree_rel(got: dict, jax_tree, rtol, what=''):
    """A port state dict against a JAX tree of the params' shape: each
    tensor within ``rtol`` of the largest entry of the whole tree (a bias
    ahead of a GroupNorm has a zero gradient in exact arithmetic, so its
    own scale is rounding noise). Returns the largest error over that
    scale."""
    want = state_dict_from_jax(jax_tree)
    assert sorted(got) == sorted(want), what
    scale = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k in want:
        err = float((got[k].detach().float() - want[k]).abs().max())
        assert err <= rtol * scale, (what, k, err, scale)
        worst = max(worst, err / scale)
    return worst


# ---------------------------------------------------------------------------
# kernel gradients
# ---------------------------------------------------------------------------

def _block_inputs(kind, b=2, n=64, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g1 = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    g2 = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    wout = (rng.normal(size=(128, c)) / np.sqrt(128)).astype(np.float32)
    bout = (0.1 * rng.normal(size=c)).astype(np.float32)
    ct = rng.normal(size=(b, n, c)).astype(np.float32)
    if kind == 'linattn':
        ws = [(rng.normal(size=(c, 128)) / np.sqrt(c)).astype(np.float32)
              for _ in range(3)]
        return [x, g1, *ws, wout, bout, g2], ct
    wqkv = (rng.normal(size=(c, 384)) / np.sqrt(c)).astype(np.float32)
    return [x, g1, wqkv, wout, bout], ct


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', ['linattn', 'attn'])
def test_block_gradients_match_the_jax_custom_vjp(kind, dtype):
    """x in the compute dtype, the gains, weights and bias float32, as the
    layers pass them; every input's gradient in its own dtype."""
    arrays, ct = _block_inputs(kind)
    if kind == 'linattn':
        jfn = lambda *a: _xla_linattn_block(*a, dim_head=32)  # noqa: E731
        tfn = lambda *a: lb.linattn_block(*a, dim_head=32)    # noqa: E731
    else:
        jfn = lambda *a: _xla_attn_block(*a, heads=4, dim_head=32)  # noqa
        tfn = lambda *a: ab.attn_block(*a, heads=4, dim_head=32)    # noqa
    jargs = [jnp.asarray(arrays[0]).astype(JDT[dtype])] + \
        [jnp.asarray(a) for a in arrays[1:]]
    out, vjp = jax.vjp(jfn, *jargs)
    jct = jnp.asarray(ct).astype(out.dtype)
    want = vjp(jct)
    targs = [torch.from_numpy(arrays[0]).to(TDT[dtype]).requires_grad_()] + \
        [torch.from_numpy(a).requires_grad_() for a in arrays[1:]]
    got = tfn(*targs)
    assert_rel(got, np.asarray(out.astype(jnp.float32)),
               GRAD_RTOL[dtype], 'forward')
    got.backward(torch.from_numpy(np.array(jct.astype(jnp.float32)))
                 .to(got.dtype))
    for i, (t, w) in enumerate(zip(targs, want)):
        assert t.grad is not None and t.grad.dtype == t.dtype, i
        assert_rel(t.grad, np.asarray(w.astype(jnp.float32)),
                   GRAD_RTOL[dtype], f'grad {i}')


def test_block_functions_forward_the_plain_version_and_save_only_inputs():
    """On the CPU the Function's forward is the plain version, bit for bit,
    and its backward recomputes it without launching a kernel."""
    arrays, ct = _block_inputs('linattn')
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = lb.linattn_block(*t, dim_head=32)
    assert torch.equal(out, lb.linattn_block_plain(*t, dim_head=32))
    assert type(out.grad_fn).__name__.startswith('_LinattnBlock')
    # only the primal inputs are saved
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 8 and all(a is b for a, b in zip(saved, t))
    before = lb.launches
    out.backward(torch.from_numpy(ct))
    assert lb.launches == before
    assert all(x.grad is not None for x in t)


def _raises_on_backward(fn, *inputs):
    out = fn(*inputs)
    with pytest.raises(RuntimeError, match='has no gradient.*use_pallas_kernels'
                                          '.*flash_attn'):
        out.float().sum().backward()


def test_forward_only_kernels_raise_the_named_error_on_backward():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 16)).astype(np.float32))
    gamma, beta = torch.ones(16), torch.zeros(16)
    # forward-only callers see the plain version
    assert torch.equal(gs.groupnorm_silu(x, gamma, beta),
                       gs.groupnorm_silu_plain(x, gamma, beta))
    _raises_on_backward(gs.groupnorm_silu, x.requires_grad_(), gamma, beta)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 16, 32))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    _raises_on_backward(at.attention, q, k, v)
    qkv = torch.from_numpy(rng.normal(size=(2, 16, 96)).astype(np.float32))
    _raises_on_backward(la.linear_attention_qkv, qkv.requires_grad_())
    _raises_on_backward(la.linear_attention, *(t.requires_grad_() for t in
                                               qkv.detach().chunk(3, -1)))


def test_use_pallas_net_backward_raises_the_named_error():
    net = SRUnet(dim=8, dim_mults=(1, 2), full_attn=(False, True),
                 learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
                 use_pallas=True)
    net.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 16, 16)
    out = net(x, torch.rand(1))
    with pytest.raises(RuntimeError, match='has no gradient'):
        out.sum().backward()


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(dtype):
    kw = dict(dim=8, dim_mults=(1, 2), full_attn=(False, True),
              learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
              num_classes=3, dtype=TDT[dtype])
    rng = np.random.default_rng(0)
    hr = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    label = torch.tensor([0, 2])
    results = []
    for remat in (False, True):
        net = SRUnet(**kw, remat=remat)
        net.init_weights(torch.Generator().manual_seed(1))
        wrapper = ContinuousDiffusion(net, image_size=16, cond_drop_prob=0.1)
        loss = wrapper.loss(hr, cond, label, draws=GeneratorDraws(5, 'cpu'))
        loss.backward()
        results.append((loss.detach(),
                        {k: p.grad for k, p in net.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# optimizers, schedules, EMA
# ---------------------------------------------------------------------------

SCHED_BASE = dict(lr=1e-3, min_lr=1e-6, warmup_epochs=2, epochs=10,
                  warmup_lr_init=1e-6)


@pytest.mark.parametrize('case', ['cosine', 'CosineAnnealingLR',
                                  'WarmupLinear', 'ReduceLROnPlateau',
                                  'constant', 'cosine_epoch'])
def test_lr_schedules_match_optax(case):
    name = case.replace('_epoch', '')
    kw = dict(SCHED_BASE, scheduler=name,
              cosine_interval_type='epoch' if 'epoch' in case else 'step')
    conf, jconf = Config(**kw), JaxConfig(**kw)
    got = trainer._maybe_epoch_quantize(trainer.make_lr_schedule(conf, 10),
                                        conf, 10)
    want = jtrainer._maybe_epoch_quantize(jtrainer.make_lr_schedule(jconf, 10),
                                          jconf, 10)
    for k in range(0, 130, 3):
        v = got(k)
        assert isinstance(v, np.float32)
        assert_rel(np.float32(v), np.asarray(want(jnp.int32(k)), np.float32),
                   OPT_RTOL, f'{case} step {k}')


OPTIMIZERS = {
    'adamw': dict(optimizer='adamw', weight_decay=0.05),
    'adamw_amsgrad': dict(optimizer='adamw', weight_decay=0.05, amsgrad=True),
    'adam': dict(optimizer='adam'),
    'adam_amsgrad': dict(optimizer='adam', amsgrad=True),
    'sgd': dict(optimizer='sgd', momentum=0.9),
    'sgd_nesterov': dict(optimizer='sgd', momentum=0.8, nesterov=True),
    'madgrad': dict(optimizer='madgrad', weight_decay=0.01),
    'madgrad_coupled': dict(optimizer='madgrad', weight_decay=0.01,
                            madgrad_decoupled_decay=False),
    'adamw_plateau': dict(optimizer='adamw', scheduler='ReduceLROnPlateau',
                          patience=1, factor=0.5),
    'sgd_epoch': dict(optimizer='sgd', cosine_interval_type='epoch'),
}

# the optax state fields, per port state key
_STATE_FIELDS = ('mu', 'nu', 'nu_max', 'trace', 's', 'nu', 'x0')


def _optax_field(state, field):
    """{param name: leaf} of the optax state's ``field`` sub-tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(p, 'name', getattr(p, 'key', None)) for p in path]
        if field in names:
            out[names[-1]] = np.asarray(leaf)
    return out


@pytest.mark.parametrize('case', list(OPTIMIZERS))
def test_optimizers_match_optax_over_five_steps(case):
    kw = dict(lr=1e-2, min_lr=1e-4, epochs=2, warmup_epochs=1,
              warmup_lr_init=1e-3, **OPTIMIZERS[case])
    conf, jconf = Config(**kw), JaxConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = {'w': rng.normal(size=(4, 3)).astype(np.float32),
          'b': rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    grads[2]['b'][:] = 0.0        # zero gradients on a step
    values = [1.0, 1.0, 0.5, 0.5, 0.5]   # the plateau's training losses

    jopt = jtrainer.make_optimizer(jconf, steps_per_epoch=3)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = trainer.make_optimizer(conf, params, steps_per_epoch=3)
    for k, (g, value) in enumerate(zip(grads, values)):
        updates, jstate = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                      jstate, jparams,
                                      value=jnp.float32(value))
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        trainer.set_lr(opt, k)
        opt.step(value=torch.tensor(value))
        for n in params:
            assert_rel(params[n], np.asarray(jparams[n]), OPT_RTOL,
                       f'{case} step {k} {n}')
    index = {id(p): n for n, p in params.items()}
    compared = 0
    for field in set(_STATE_FIELDS):
        want = _optax_field(jstate, field)
        for p, st in opt.state.items():
            if field in st:
                assert_rel(st[field], want[index[id(p)]], OPT_RTOL,
                           f'{case} {field}')
                compared += 1
    assert compared >= 2
    if opt.plateau is not None:
        scale = float(np.asarray(_optax_field(jstate, 'scale')['scale']))
        assert float(opt.plateau.scale) == scale < 1.0


def test_plateau_rejects_max_mode():
    conf = Config(scheduler='ReduceLROnPlateau', plateau_mode='max')
    with pytest.raises(ValueError, match='plateau_mode'):
        trainer.make_optimizer(conf, {'w': torch.ones(3)})


def test_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    e = {'a': rng.normal(size=(3, 4)).astype(np.float32),
         'b': rng.normal(size=(7,)).astype(np.float32)}
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    want = jax_ema_update(e, p, 0.999)
    got = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    ema_update(got, {k: torch.from_numpy(v) for k, v in p.items()}, 0.999)
    for k in e:
        assert_rel(got[k], np.asarray(want[k]), OPT_RTOL, k)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

TINY = dict(model='conditional_continuous', unet_dim=8,
            ddpm_unet_dim_mults='1,2', full_attn='False,True',
            learned_sinusoidal_cond=True, learned_sinusoidal_dim=4,
            hr_image_size=16, lr_image_size=4, batch_size=2, num_workers=1,
            epochs=1, warmup_epochs=0, ema_decay=0.9, seed=0, lr=1e-3,
            min_lr=1e-5)
# one step in bfloat16: the two packages' convolutions and matmuls sum in
# other orders, and their bf16 roundings follow; the loss within 1e-3 and
# each gradient within 5e-2 of the largest gradient
STEP_RTOL = {'float32': {'loss': 1e-5, 'grad': 1e-4},
             'bfloat16': {'loss': 1e-3, 'grad': 5e-2}}


def port_weights_into_jax(net):
    """The port net's weights as the JAX net's params tree."""
    params, unmatched = convert_unet_state_dict(
        {k: v.detach().float().numpy() for k, v in net.state_dict().items()},
        num_stages=len(net.downs))
    assert not unmatched
    return {'params': params}


def replay_jax_step_keys(monkeypatch, family='continuous'):
    """The port's train steps draw what the JAX step of the same seed and
    step draws: ``fold_in(PRNGKey(seed), step)`` split as the loss splits
    it."""
    monkeypatch.setattr(trainer, 'step_draws', lambda seed, step, device:
                        JaxDraws(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                    step), family))


def _adam_moment(jstate, field):
    """The JAX optimizer state's ``field`` tree, as a params tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jstate, is_leaf=lambda x: hasattr(x, field))[0]:
        if hasattr(leaf, field):
            return getattr(leaf, field)
    raise KeyError(field)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_train_step_matches_jax(dtype, monkeypatch):
    """``make_train_step`` against the JAX step: the same weights, uint8
    batch and replayed keys. The loss and gradients (the JAX ones read from
    Adam's first moment) at ``STEP_RTOL``, each gradient against the
    largest of all (``assert_tree_rel``); the first Adam step moves each parameter by about lr times the sign of its
    gradient, so parameters are held within 2 lr and the EMA within
    (1 - decay) 2 lr, and the first moment (0.1 g) with the gradients."""
    conf = Config(**TINY, compute_dtype=dtype)
    jconf = JaxConfig(**TINY, compute_dtype=dtype)
    net = build_unet_from_config(conf)
    net.init_weights(torch.Generator().manual_seed(3))
    wrapper = build_wrapper(conf, net)
    params = port_weights_into_jax(net)
    jnet = jax_build_unet(jconf)
    jwrapper = jax_build_wrapper(jconf, jnet)
    rng = np.random.default_rng(11)
    hr = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    cond = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    label = np.array([0, 2], np.int32)

    jopt = jtrainer.make_optimizer(jconf, steps_per_epoch=4)
    jstep = jax.jit(jtrainer.make_train_step(jwrapper, jopt, 0.9, True))
    key = jax.random.PRNGKey(conf.seed)
    jstate, jloss = jstep(jtrainer.create_train_state(params, jopt), key,
                          jnp.asarray(hr), jnp.asarray(cond),
                          jnp.asarray(label))
    # Adam's first moment after one step is (1 - b1) g
    jmu = _adam_moment(jstate.opt_state, 'mu')
    jgrads = jax.tree.map(lambda m: m / 0.1, jmu)

    replay_jax_step_keys(monkeypatch)
    live = trainer.trainable_params(wrapper)
    state = trainer.create_train_state(
        live, trainer.make_optimizer(conf, live, steps_per_epoch=4))
    step = trainer.make_train_step(wrapper, 0.9, True, conf.seed)
    loss = step(state, torch.from_numpy(hr), torch.from_numpy(cond),
                torch.from_numpy(label).long())
    assert state.step == 1
    tol = STEP_RTOL[dtype]
    assert_rel(loss, np.asarray(jloss), tol['loss'], 'loss')
    assert_tree_rel({k: p.grad for k, p in live.items()}, jgrads,
                    tol['grad'], 'grad')
    mu = {k: state.optimizer.state[p]['mu'] for k, p in live.items()}
    assert_tree_rel(mu, jmu, tol['grad'], 'mu')
    for name, got, want, atol in (
            ('params', live, jstate.params, 2 * conf.lr),
            ('ema', state.ema_params, jstate.ema_params,
             (1 - 0.9) * 2 * conf.lr)):
        want = state_dict_from_jax(want)
        for k in want:
            assert got[k].dtype == torch.float32
            err = float((got[k].detach() - want[k]).abs().max())
            assert err <= atol, (name, k, err)
