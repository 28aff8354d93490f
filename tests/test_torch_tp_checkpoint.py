"""PyTorch port: training checkpoints under tensor parallelism
(``training/loop.py``: the global state gathered over the model group and
written by rank 0, each rank's dim-0 slice cut on restore), across 4 gloo
ranks on the CPU: a ``(data 2, model 2)`` mesh, the tiny UNet.

``train_lora`` and ``train_full`` run 4 steps without a break, and 2 then
2 more resumed from the checkpoint written at step 2; the resumed runs are
bit-equal to the unbroken ones. The step-2 checkpoint written under the
mesh resumes in this process without one, and one written here without a
mesh resumes under the mesh: both within 1e-4 of the unbroken mesh run
(``test_torch_parallel.py``'s bound for the TP UNet), and 1e-7 on average
(AdamW normalises every gradient element, so an element whose gradient is
near 0 moves by a visible part of the learning rate on summation-order
noise; a checkpoint restored into the wrong slices moves them all). One
spawn runs every case.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.training.train import factor_tree

T, D = 7, 32
STEPS, BREAK = 4, 2
CFG = dict(learning_rate=1e-4, weight_decay=0.0)
ATOL, MEAN = 1e-4, 1e-7
MODES = ('lora', 'full')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unet(state) -> torch.nn.Module:
    m = tm.UNet2DCondition(tm.TINY_UNET)
    m.load_state_dict(torch.load(state, weights_only=True), strict=True)
    return m


def _dataset(n=4):
    rng = np.random.default_rng(0)
    return tt.EncodedDataset(
        torch.from_numpy(rng.normal(size=(n, 8, 8, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(n, 8, 8, 4)).astype(np.float32)
                         - 4),
        torch.from_numpy(rng.normal(size=(n, T, D)).astype(np.float32)),
        [f'cap {i}' for i in range(n)])


def _train(mode, state, steps, mesh=None, cdir=None):
    """``mode``'s loop on a fresh UNet (sharded under ``mesh``): its trained
    tensors, whole (gathered over the model group), and losses."""
    from flexdiffuse_tpu_torch.parallel import shard_params
    from flexdiffuse_tpu_torch.training.loop import full_tree
    unet = _unet(state).requires_grad_(mode == 'full')
    if mesh is not None:
        shard_params(unet, mesh)
    kw = dict(steps=steps, batch_size=4, seed=5, mesh=mesh, log_every=1,
              checkpoint_dir=cdir, checkpoint_every=BREAK)
    cfg = tt.TrainConfig(**CFG)
    if mode == 'lora':
        factors, losses = tt.train_lora(unet, _dataset(), cfg, rank=2, **kw)
        tree = factor_tree(factors)
    else:
        tree, losses = tt.train_full(unet, _dataset(), cfg, **kw)
        tree = full_tree(unet, tree, mesh)
    return {n: t.detach().clone() for n, t in tree.items()}, losses


def _worker(rank, world, state, out_dir):
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel import make_mesh
    from flexdiffuse_tpu_torch.training.checkpoint import TrainCheckpointer
    mesh = make_mesh(model_parallel=2)
    saves = []
    real_save = TrainCheckpointer.save

    def save(self, next_step, st, losses):
        saves.append(next_step)
        return real_save(self, next_step, st, losses)

    TrainCheckpointer.save = save
    res = {}
    try:
        for mode in MODES:
            res[f'{mode}_whole'] = _train(mode, state, STEPS, mesh)
            cdir = os.path.join(out_dir, f'{mode}_tp')
            _train(mode, state, BREAK, mesh, cdir)
            if rank == 0:   # the step-2 file, before the resume adds one
                shutil.copytree(cdir, cdir + '_at2')
            dist.barrier()
            res[f'{mode}_resumed'] = _train(mode, state, STEPS, mesh, cdir)
            res[f'{mode}_from_plain'] = _train(
                mode, state, STEPS, mesh,
                os.path.join(out_dir, f'{mode}_plain'))
    finally:
        TrainCheckpointer.save = real_save
    counts = [None] * world
    dist.all_gather_object(counts, saves)
    if rank == 0:
        torch.save(dict(res, saves=counts), os.path.join(out_dir, 'tp.pt'))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' runs, and this process's: a checkpoint at step 2 without
    a mesh (resumed by the ranks), the ranks' step-2 checkpoint resumed
    without a mesh."""
    from flexdiffuse_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp('tp_ckpt')
    torch.manual_seed(0)
    state = str(out / 'unet.pt')
    torch.save(tm.UNet2DCondition(tm.TINY_UNET).state_dict(), state)
    for mode in MODES:
        _train(mode, state, BREAK, cdir=str(out / f'{mode}_plain'))
    launch.spawn(_worker, 4, device='cpu', args=(state, str(out)),
                 timeout=120, join_timeout=400)
    got = torch.load(out / 'tp.pt', weights_only=False)
    for mode in MODES:
        got[f'{mode}_to_plain'] = _train(mode, state, STEPS,
                                         cdir=str(out / f'{mode}_tp_at2'))
    got['out'] = out
    return got


def _close(got, want):
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        d = np.abs(got[name].numpy() - t.numpy())
        assert d.max() <= ATOL and d.mean() <= MEAN, (name, d.max(),
                                                      d.mean())


@pytest.mark.parametrize('mode', MODES)
def test_tp_resume_is_bit_equal(runs, mode):
    """Interrupted after step 2 of 4 under the mesh and resumed: the same
    losses and trained tensors, bit for bit, as the unbroken run."""
    got, losses = runs[f'{mode}_resumed']
    want, want_losses = runs[f'{mode}_whole']
    assert losses == want_losses   # the first two from the checkpoint
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize('mode', MODES)
def test_tp_checkpoint_resumes_without_mesh(runs, mode):
    """The step-2 checkpoint written under model 2 resumes in one process
    and ends within 1e-4 of the unbroken model-2 run."""
    got, losses = runs[f'{mode}_to_plain']
    want, want_losses = runs[f'{mode}_whole']
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
    _close(got, want)


@pytest.mark.parametrize('mode', MODES)
def test_plain_checkpoint_resumes_under_tp(runs, mode):
    """A checkpoint written at step 2 without a mesh resumes under model 2
    and ends within 1e-4 of the unbroken model-2 run."""
    got, losses = runs[f'{mode}_from_plain']
    want, want_losses = runs[f'{mode}_whole']
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
    _close(got, want)


def test_tp_rank0_writes_global_state_once(runs):
    """Rank 0 alone wrote each checkpoint, once (per mode step 2 of the
    broken run, step 4 of its resumption and of the resumption of the
    checkpoint written without a mesh); the full fine-tune's file holds
    the unsharded tensors and AdamW moments."""
    per_run = [BREAK, STEPS, STEPS] * len(MODES)
    assert runs['saves'] == [per_run, [], [], []]
    cdir = runs['out'] / 'full_tp_at2'
    blob = torch.load(cdir / 'step_00000002.pt', weights_only=True)
    shapes = {n: tuple(p.shape) for n, p in
              tm.UNet2DCondition(tm.TINY_UNET).named_parameters()}
    tree = blob['state']['tree']
    assert {n: tuple(t.shape) for n, t in tree.items()} == shapes
    moments = blob['state']['opt_state']['adamw']['state']
    assert [tuple(m['exp_avg'].shape) for _, m in sorted(moments.items())] \
        == list(shapes.values())
