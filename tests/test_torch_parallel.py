"""PyTorch port: meshes, data and tensor parallelism (``parallel/mesh.py``,
the training steps' and loops' ``mesh=``) across gloo ranks on the CPU,
held against the port on one process and the JAX package's sharded runs on
its 8 virtual devices (``tests/test_parallel.py``, ``__graft_entry__.
dryrun_multichip``).

Two spawns: 2 ranks (a ``(2, 1)`` mesh: data parallelism, the denoise
step and the training loops) and 4 ranks (a ``(2, 2)`` mesh: the mesh
rules, the tensor-parallel UNet and the DP×TP dryrun). TINY_UNET carries
the JAX package's init (converted). The JAX references and the
single-process runs are computed in this process and handed to the ranks
as files; the ranks import no JAX. Tolerances: the denoise step 1e-5, the
TP UNet 1e-4 (``test_parallel.py``'s); training losses and trained tensors
1e-5 (observed ≤ 4e-7).
"""
import os

import numpy as np
import pytest
import torch
from torch import nn

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.training.train import factor_tree

T, D = 7, 32
ATOL_TRAIN = 1e-5
CFG = dict(learning_rate=5e-3, weight_decay=0.0)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules_module() -> nn.Module:
    """JAX's tree ``{dense 16→64, odd 16→33, scalar}`` (test_parallel.py
    :20-30) as torch layers."""
    m = nn.Module()
    m.dense = nn.Linear(16, 64)
    m.odd = nn.Linear(16, 33, bias=False)
    m.scalar = nn.Parameter(torch.zeros(()))
    return m


def _unet(state) -> nn.Module:
    m = tm.UNet2DCondition(tm.TINY_UNET)
    m.load_state_dict(torch.load(state, weights_only=True), strict=True)
    return m


def _dataset(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return tt.EncodedDataset(
        torch.from_numpy(rng.normal(size=(n, 8, 8, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(n, 8, 8, 4)).astype(np.float32)
                         - 4),
        torch.from_numpy(rng.normal(size=(n, T, D)).astype(np.float32)),
        [f'cap {i}' for i in range(n)])


def _denoise_inputs(b):
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    ctx = np.random.default_rng(1).normal(size=(b, 77, 32)).astype(
        np.float32)
    return torch.from_numpy(lat), torch.from_numpy(ctx)


def _eps(unet, lat, ctx):
    with torch.no_grad():
        return unet(lat, torch.full((lat.shape[0],), 300.0), ctx)


def _train_runs(state, mesh, out_dir):
    """The training loops at batch 4; ``out_dir`` holds their outputs and
    a checkpoint directory (rank 0 writes)."""
    cfg = tt.TrainConfig(**CFG)
    res = {}
    factors, res['lora_losses'] = tt.train_lora(
        _unet(state), _dataset(), cfg, rank=2, steps=3, batch_size=4,
        mesh=mesh, log_every=1,
        save_path=os.path.join(out_dir, 'lora.safetensors'))
    res['lora'] = factor_tree(factors)
    tree, res['full_losses'] = tt.train_full(
        _unet(state), _dataset(), cfg, steps=3, batch_size=4, mesh=mesh,
        log_every=1)
    res['full'] = tree
    db, res['db_losses'] = tt.train_dreambooth(
        _unet(state), _dataset(4, seed=1), _dataset(4, seed=2), cfg=cfg,
        prior_weight=0.7, mode='lora', rank=2, steps=3, batch_size=2,
        mesh=mesh, log_every=1)
    res['db'] = factor_tree(db)
    # Interrupted at 3 of 6, then resumed, on the same ranks.
    cdir = os.path.join(out_dir, 'ckpt')
    tt.train_full(_unet(state), _dataset(), cfg, steps=3, batch_size=4,
                  seed=7, mesh=mesh, log_every=1, checkpoint_dir=cdir)
    tree, res['resumed_losses'] = tt.train_full(
        _unet(state), _dataset(), cfg, steps=6, batch_size=4, seed=999,
        mesh=mesh, log_every=1, checkpoint_dir=cdir)
    res['resumed'] = tree
    return {k: ({n: t.detach().clone() for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in res.items()}


def _dp_worker(rank, world, state, out_dir):
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel import make_mesh, shard_batch
    from flexdiffuse_tpu_torch.parallel.axis import gather
    from flexdiffuse_tpu_torch.parallel.mesh import batch_sharding
    mesh = make_mesh(model_parallel=1)
    lat, ctx = shard_batch(_denoise_inputs(8), mesh)
    eps = gather(_eps(_unet(state), lat, ctx), batch_sharding(mesh), 0)
    res = _train_runs(state, mesh, out_dir)
    if dist.get_rank() == 0:
        torch.save(dict(res, eps=eps), os.path.join(out_dir, 'dp.pt'))


def _dryrun(unet, lat, ctx, unc):
    """``dryrun_multichip``'s program: a CFG denoise step with PNDM, the
    DeepCache save/use split against the full forward, a LoRA step and a
    full step."""
    from flexdiffuse_tpu_torch import schedulers
    schedule = schedulers.make('pndm', 4)
    state0 = schedulers.init_state(schedule, lat.shape, lat.dtype)
    lat2, ctx2 = torch.cat([lat, lat]), torch.cat([unc, ctx])
    t = schedule.timesteps[0].expand(lat2.shape[0])
    with torch.no_grad():
        full = unet(lat2, t, ctx2)
        eps_u, eps_c = full.chunk(2)
        eps = eps_u + 8.0 * (eps_c - eps_u)
        _, new = schedulers.step(schedule, state0, eps, 0, 0, lat, 0.0)
        eps_s, cache = unet(lat2, t, ctx2, cache_mode='save')
        eps_use, _ = unet(lat2, t, ctx2, deep_cache=cache, cache_mode='use')
    cfg = tt.TrainConfig(learning_rate=1e-4)
    g = torch.Generator().manual_seed(3)
    return new, full, eps_s, eps_use, g, cfg


def _tp_worker(rank, world, state, out_dir):
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel.axis import gather
    from flexdiffuse_tpu_torch.parallel import (make_mesh, param_shardings,
                                                replicated, shard_batch,
                                                shard_params)
    from flexdiffuse_tpu_torch.parallel.mesh import batch_sharding
    res = {}
    mesh = make_mesh(model_parallel=2)
    res['mesh'] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    mine = {'a': torch.full((3,), float(rank)), 'b': torch.tensor(rank)}
    replicated(mine, mesh)
    seen = [torch.empty(4) for _ in range(world)]
    dist.all_gather(seen, torch.cat([mine['a'], mine['b'][None].float()]))
    res['replicated'] = torch.stack(seen)
    try:
        make_mesh([0, 1, 2], model_parallel=2)
        res['three'] = ''
    except ValueError as e:
        res['three'] = str(e)
    m = shard_params(_rules_module(), mesh)
    res['rules'] = {n: tuple(p.shape) for n, p in m.named_parameters()}
    res['rule_specs'] = param_shardings(m, mesh)
    # The TP UNet on the full batch (every model group runs it).
    lat, ctx = _denoise_inputs(2)
    tp_unet = shard_params(_unet(state), mesh)
    res['tp_eps'] = _eps(tp_unet, lat, ctx)
    # The dryrun over the DP×TP mesh: 2 images per data shard.
    data = batch_sharding(mesh)
    rng = np.random.default_rng(4)
    glat = torch.from_numpy(rng.normal(size=(4, 16, 16, 4)).astype(
        np.float32))
    gctx = torch.from_numpy(rng.normal(size=(4, 77, 32)).astype(np.float32))
    gunc = torch.zeros_like(gctx)
    lat, ctx, unc = shard_batch((glat, gctx, gunc), mesh)
    new, full, eps_s, eps_use, g, cfg = _dryrun(tp_unet, lat, ctx, unc)
    res['dry_new'] = gather(new, data, 0)
    res['dry_save'] = float((full - eps_s).abs().max())
    res['dry_use'] = float((full - eps_use).abs().max())
    lunet = _unet(state)
    factors = tt.init_lora(lunet, rank=4,
                           generator=torch.Generator().manual_seed(1))
    shard_params(lunet, mesh)
    lstep, _ = tt.make_lora_train_step(lunet, factors, cfg, mesh=mesh)
    res['lora_losses'] = [float(lstep(glat, gctx, generator=g))
                          for _ in range(2)]
    res['lora'] = {n: t.detach().clone()
                   for n, t in factor_tree(factors).items()}
    funet = shard_params(_unet(state).requires_grad_(True), mesh)
    fstep, _ = tt.make_train_step(funet, cfg, mesh=mesh)
    g = torch.Generator().manual_seed(3)
    res['full_losses'] = [float(fstep(glat, gctx, generator=g))
                          for _ in range(2)]
    from flexdiffuse_tpu_torch.training.loop import full_tree
    res['full'] = {n: t.detach().clone() for n, t in full_tree(
        funet, dict(funet.named_parameters()), mesh).items()}
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(out_dir, 'tp.pt'))


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    """TINY_UNET's JAX init as a port state dict, and JAX's sharded runs:
    the DP denoise step (``shard_batch``) and the TP UNet
    (``shard_params``, model=2) on the 8 virtual devices."""
    import jax
    import jax.numpy as jnp

    from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
    from flexdiffuse_tpu.parallel import (make_mesh, shard_batch,
                                          shard_params)
    from flexdiffuse_tpu_torch.weights import params_to_state_dict
    unet = UNet2DCondition(TINY_UNET)
    params = unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    out = tmp_path_factory.mktemp('parallel')
    state = str(out / 'unet.pt')
    torch.save(params_to_state_dict(jax.tree.map(np.asarray, params),
                                    TINY_UNET), state)
    fn = jax.jit(lambda p, l, c: unet.apply(p, l, jnp.full(
        (l.shape[0],), 300.0), c))
    lat, ctx = (jnp.asarray(x.numpy()) for x in _denoise_inputs(8))
    mesh = make_mesh(model_parallel=1)
    with mesh:
        dp = np.asarray(fn(params, *shard_batch((lat, ctx), mesh)))
    lat, ctx = (jnp.asarray(x.numpy()) for x in _denoise_inputs(2))
    mesh = make_mesh(model_parallel=2)
    with mesh:
        tp = np.asarray(fn(shard_params(params, mesh), lat, ctx))
    return dict(state=state, out=out, dp=dp, tp=tp)


@pytest.fixture(scope='module')
def dp_ranks(jax_side):
    from flexdiffuse_tpu_torch.parallel import launch
    out = jax_side['out'] / 'dp'
    out.mkdir()
    launch.spawn(_dp_worker, 2, device='cpu',
                 args=(jax_side['state'], str(out)), timeout=120,
                 join_timeout=400)
    got = torch.load(out / 'dp.pt', weights_only=False)
    want = _train_runs(jax_side['state'], None, str(jax_side['out']))
    return got, want, out


@pytest.fixture(scope='module')
def tp_ranks(jax_side):
    from flexdiffuse_tpu_torch.parallel import launch
    out = jax_side['out'] / 'tp'
    out.mkdir()
    launch.spawn(_tp_worker, 4, device='cpu',
                 args=(jax_side['state'], str(out)), timeout=120,
                 join_timeout=400)
    return torch.load(out / 'tp.pt', weights_only=False)


def test_shard_params_rules():
    """The rule in torch's layout (dim 0) is JAX's (the last dim) on the
    same tree: dense sharded, the odd 33 and the scalar replicated."""
    from jax.sharding import PartitionSpec as P

    from flexdiffuse_tpu.parallel.mesh import _param_spec
    from flexdiffuse_tpu_torch.parallel import param_shardings
    got = param_shardings(_rules_module(), 2)
    assert got == {'dense.weight': 0, 'dense.bias': 0, 'odd.weight': None,
                   'scalar': None}
    jax_leaves = {'dense.weight': np.zeros((16, 64)),
                  'dense.bias': np.zeros((64,)),
                  'odd.weight': np.zeros((16, 33)), 'scalar': np.zeros(())}
    for name, leaf in jax_leaves.items():
        sharded = _param_spec((), leaf, 2) != P()
        assert sharded == (got[name] == 0), name


def test_seed_sweep_keys_unique():
    from flexdiffuse_tpu_torch.parallel import seed_sweep_keys
    keys = seed_sweep_keys(1337, 8)
    assert keys.shape == (8,) and len(set(keys.tolist())) == 8
    assert torch.equal(keys, seed_sweep_keys(1337, 8))


def test_mesh_shapes_and_rules_on_ranks(tp_ranks):
    """World 4, ``model_parallel=2``: a (data 2, model 2) mesh; 3 ranks do
    not split into model groups of 2 (test_parallel.py:13-17). Sharded,
    the dense layer keeps half its rows; ``replicated`` makes every rank
    hold rank 0's tensors."""
    assert tp_ranks['mesh'] == ((2, 2), ('data', 'model'))
    assert not tp_ranks['replicated'].any()   # every rank holds rank 0's
    assert 'not divisible by model_parallel=2' in tp_ranks['three']
    assert tp_ranks['rules'] == {'dense.weight': (32, 16),
                                 'dense.bias': (32,),
                                 'odd.weight': (33, 16), 'scalar': ()}
    assert tp_ranks['rule_specs'] == {'dense.weight': 0, 'dense.bias': 0,
                                      'odd.weight': None, 'scalar': None}


def test_dp_denoise_matches_world1_and_jax(jax_side, dp_ranks):
    """A denoise step over 8 rows on 2 data ranks equals one process and
    JAX's ``shard_batch`` run."""
    got = dp_ranks[0]['eps'].numpy()
    want = _eps(_unet(jax_side['state']), *_denoise_inputs(8)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jax_side['dp'], rtol=0, atol=1e-5)


def test_tp_unet_matches_replicated_and_jax(jax_side, tp_ranks):
    """The UNet sharded over a model axis of 2 equals the replicated port
    UNet and JAX's ``shard_params`` run."""
    got = tp_ranks['tp_eps'].numpy()
    want = _eps(_unet(jax_side['state']), *_denoise_inputs(2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, jax_side['tp'], rtol=0, atol=1e-4)


@pytest.mark.parametrize('mode', ['lora', 'full', 'db', 'resumed'])
def test_dp_training_matches_world1(dp_ranks, mode):
    """``train_lora``, ``train_full``, ``train_dreambooth`` (LoRA, the
    per-row prior weights sharded with their rows) and a ``train_full``
    resumed from a checkpoint that rank 0 wrote at step 3: on 2 ranks as
    in one process, losses and trained tensors. The full fine-tunes'
    tensors are held to 1e-4 each and 1e-7 on average: AdamW normalises
    every gradient element, so an element whose gradient is near 0 moves
    by a visible part of the learning rate on summation-order noise
    (observed 2.4e-5 in 1 of 36,864 elements at lr 5e-3; a missing
    all-reduce moves them all)."""
    got, want, _ = dp_ranks
    np.testing.assert_allclose(got[f'{mode}_losses'], want[f'{mode}_losses'],
                               rtol=0, atol=ATOL_TRAIN)
    assert sorted(got[mode]) == sorted(want[mode])
    full = mode in ('full', 'resumed')
    for name, t in want[mode].items():
        d = np.abs(got[mode][name].numpy() - t.numpy())
        assert d.max() <= (1e-4 if full else ATOL_TRAIN), (name, d.max())
        assert d.mean() <= 1e-7, (name, d.mean())


def test_dp_rank0_writes_outputs(dp_ranks):
    """Rank 0 wrote the adapter (the same tensors as one process writes)
    and the checkpoints; nothing was written twice."""
    from flexdiffuse_tpu_torch.weights import safetensors as st
    _, _, out = dp_ranks
    got = st.load_file(str(out / 'lora.safetensors'))
    assert got and all(k.startswith('lora_unet_') for k in got)
    assert sorted(os.listdir(out / 'ckpt')) == ['step_00000003.pt',
                                                'step_00000006.pt']


def test_dryrun_multichip_dp2_tp2(jax_side, tp_ranks):
    """``dryrun_multichip``'s program at world 4 (DP 2 × TP 2): the CFG
    denoise step equals one process on the full batch; DeepCache's save
    and use reproduce the full forward (< 1e-5, JAX's bound); a LoRA step
    and a full step over the mesh give the losses and tensors of one
    process."""
    state = jax_side['state']
    rng = np.random.default_rng(4)
    glat = torch.from_numpy(rng.normal(size=(4, 16, 16, 4)).astype(
        np.float32))
    gctx = torch.from_numpy(rng.normal(size=(4, 77, 32)).astype(np.float32))
    new, *_ = _dryrun(_unet(state), glat, gctx, torch.zeros_like(gctx))
    np.testing.assert_allclose(tp_ranks['dry_new'].numpy(), new.numpy(),
                               rtol=0, atol=1e-4)
    assert tp_ranks['dry_save'] < 1e-5 and tp_ranks['dry_use'] < 1e-5
    cfg = tt.TrainConfig(learning_rate=1e-4)
    lunet = _unet(state)
    factors = tt.init_lora(lunet, rank=4,
                           generator=torch.Generator().manual_seed(1))
    lstep, _ = tt.make_lora_train_step(lunet, factors, cfg)
    g = torch.Generator().manual_seed(3)
    losses = [float(lstep(glat, gctx, generator=g)) for _ in range(2)]
    np.testing.assert_allclose(tp_ranks['lora_losses'], losses, rtol=0,
                               atol=ATOL_TRAIN)
    for name, t in factor_tree(factors).items():
        np.testing.assert_allclose(tp_ranks['lora'][name].numpy(),
                                   t.detach().numpy(), rtol=0,
                                   atol=ATOL_TRAIN, err_msg=name)
    funet = _unet(state).requires_grad_(True)
    fstep, _ = tt.make_train_step(funet, cfg)
    g = torch.Generator().manual_seed(3)
    losses = [float(fstep(glat, gctx, generator=g)) for _ in range(2)]
    np.testing.assert_allclose(tp_ranks['full_losses'], losses, rtol=0,
                               atol=ATOL_TRAIN)
    for name, p in funet.named_parameters():
        np.testing.assert_allclose(tp_ranks['full'][name].numpy(),
                                   p.detach().numpy(), rtol=0,
                                   atol=ATOL_TRAIN, err_msg=name)
