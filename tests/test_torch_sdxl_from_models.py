"""PyTorch port: ``SDXLRunner.from_models`` against the snapshot path, the
``fd.encode`` spans of ``SDXLTextEncoder`` and the scheduler config's way
to the pipelines, on the tiny SDXL and refiner snapshots of
``tests/test_sdxl_product.py`` (fp32, CPU)."""
import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch import sdxl_runner as tsr
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from tests.test_sdxl_product import (refiner_snapshot,  # noqa: F401
                                     xl_snapshot)  # noqa: F401
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_sdxl_product import _load_kw
from tests.test_torch_spans import _profiled

GEN = dict(prompt='a deer in the snow', negative_prompt='blurry', steps=3,
           init_size=(64, 64), samples=2, seed=11, save=False)


def _disk(root, vocab, out, refiner=None):
    rkw = {}
    if refiner is not None:
        from flexdiffuse_tpu_torch.models import TINY_REFINER_UNET
        rkw = dict(refiner_root=refiner, refiner_config=TINY_REFINER_UNET)
    return tsr.SDXLRunner(root, scheduler='dpmpp', dtype=torch.float32,
                          device='cpu', output_dir=out,
                          **_load_kw(vocab, True), **rkw)


def _u8(images):
    return np.stack([np.asarray(im.convert('RGB')) for im in images])


@pytest.mark.parametrize('refine', [False, True])
def test_from_models_gives_the_snapshot_path_images(
        xl_snapshot, refiner_snapshot, tmp_path,  # noqa: F811
        one_torch_thread, refine):  # noqa: F811
    root, vocab = xl_snapshot
    disk = _disk(root, vocab, str(tmp_path), refiner_snapshot if refine
                 else None)
    built = tsr.SDXLRunner.from_models(
        disk.pipe.unet, disk.pipe.vae, disk.text, scheduler='dpmpp',
        output_dir=str(tmp_path),
        refiner_unet=disk.refiner_pipe.unet if refine else None)
    assert built._snapshots == {} and built.vision is None
    assert built._l_dim == disk._l_dim == 24
    assert built._unet_config == disk._unet_config
    assert (built.refiner_pipe is None) == (not refine)
    with torch.no_grad():
        want, _ = disk.gen(refine_strength=0.5, **GEN)
        got, _ = built.gen(refine_strength=0.5, **GEN)
    assert len(got) == 2
    np.testing.assert_array_equal(_u8(got), _u8(want))


def test_sdxl_encodes_are_spans(xl_snapshot, tmp_path):  # noqa: F811
    root, vocab = xl_snapshot
    disk = _disk(root, vocab, str(tmp_path))
    text = disk.text
    for fn in (text.encode, text.encode_l, text.encode_refiner):
        _, events = _profiled(lambda: fn(['a deer', 'a fox']))
        assert [ev.name() for ev in events
                if ev.name().startswith('fd.')] == ['fd.encode']
    # A gen call encodes the prompt and the negative prompt once each.
    runner = tsr.SDXLRunner.from_models(disk.pipe.unet, disk.pipe.vae, text)
    _, events = _profiled(lambda: runner.gen(
        prompt='a deer', steps=1, init_size=(64, 64), seed=1, save=False))
    assert sum(ev.name() == 'fd.encode' for ev in events) == 2


def test_scheduler_config_reaches_the_pipelines(
        xl_snapshot, refiner_snapshot, tmp_path):  # noqa: F811
    root, vocab = xl_snapshot
    disk = _disk(root, vocab, str(tmp_path), refiner_snapshot)
    assert disk.pipe.scheduler_config is None
    sc = SchedulerConfig(kind='dpmpp', use_karras_sigmas=True)
    built = tsr.SDXLRunner.from_models(
        disk.pipe.unet, disk.pipe.vae, disk.text, scheduler_config=sc,
        refiner_unet=disk.refiner_pipe.unet)
    for pipe in (built.pipe, built.refiner_pipe):
        assert pipe.scheduler_config is sc
        assert pipe.scheduler_kind == 'dpmpp'
    karras = built.pipe.schedule(5).timesteps
    plain = disk.pipe.schedule(5).timesteps
    assert karras.shape == plain.shape and not torch.equal(karras, plain)
