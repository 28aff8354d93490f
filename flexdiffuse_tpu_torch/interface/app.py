"""FlexDiffuse web UI app entry (port of ``flexdiffuse_tpu/interface/app.py``).

Usage: ``python -m flexdiffuse_tpu_torch [--models DIR] [--lan] [--port N]
[--scheduler S] [--lora PATH[:S]] [--device cuda|cpu]``. The model loads on
the CUDA card (bf16) at the first request and the command raises at once
when there is no card, unless given ``--device cpu`` (fp32). ``--dl``
allows downloads as in the JAX app (the port reads snapshots already on
disk under ``--models``). ``--karras``, ``--v-prediction`` and
``--model-family sd2`` (SD-2.1 with the OpenCLIP-H text tower) build the
Runner as the JAX app does. The JAX app's ``--compile-cache``/``--no-compile-cache`` are left out: they set
XLA's compilation cache (``utils/compile_cache.py``, on ROADMAP's "Do not
port" list).
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description='FlexDiffuse UI (PyTorch '
                                                 'port)')
    parser.add_argument('--models', default='./models',
                        help='dir containing HF snapshots of SD-1.4 + CLIP')
    parser.add_argument('--dl', '--download', action='store_true',
                        dest='download',
                        help='allow downloading models from HF hub')
    parser.add_argument('--lan', action='store_true',
                        help='bind 0.0.0.0 instead of localhost')
    parser.add_argument('--port', type=int, default=7860)
    parser.add_argument('--scheduler', default='pndm',
                        choices=('ddim', 'pndm', 'lms', 'euler', 'euler_a',
                                 'dpmpp', 'ddpm', 'unipc'))
    parser.add_argument('--karras', action='store_true',
                        help='Karras sigma spacing (euler/euler_a/dpmpp/unipc)')
    parser.add_argument('--v-prediction', action='store_true',
                        help='v-parameterized model (with --model-family sd2 '
                             'for SD2.1 768-v)')
    parser.add_argument('--model-family', default='sd1',
                        choices=('sd1', 'sd2'),
                        help='checkpoint geometry: sd1 = SD1.x + ViT-L/14, '
                             'sd2 = SD2.x + OpenCLIP ViT-H')
    parser.add_argument('--lora', action='append', default=[],
                        metavar='PATH[:S]',
                        help='merge a kohya or PEFT LoRA (optional :scale, '
                             'repeatable)')
    parser.add_argument('--device', default='cuda',
                        help="torch device: 'cuda' (default; bf16, raises "
                             "without a card) or 'cpu' (fp32)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    from flexdiffuse_tpu_torch import cli
    device = cli.resolve_device(args.device)

    def make_runner():
        from flexdiffuse_tpu_torch.config import RunConfig
        from flexdiffuse_tpu_torch.runner import Runner
        from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
        from flexdiffuse_tpu_torch.weights.lora import parse_spec
        scheduler_config = None
        if args.karras or args.v_prediction:
            scheduler_config = SchedulerConfig(
                kind=args.scheduler, use_karras_sigmas=args.karras,
                prediction_type=('v_prediction' if args.v_prediction
                                 else 'epsilon'))
        model_kw = {}
        if args.model_family == 'sd2':
            c = cli.SD2_MODEL_CONFIGS
            model_kw = dict(text_config=c['text'], unet_config=c['unet'],
                            vae_config=c['vae'])
        runner = Runner(model_root=args.models,
                        config=RunConfig(local_only=not args.download),
                        scheduler=args.scheduler,
                        scheduler_config=scheduler_config,
                        dtype=cli.model_dtype(device), device=device,
                        **model_kw)
        for spec in args.lora:
            runner.apply_lora(*parse_spec(spec))
        return runner

    from flexdiffuse_tpu_torch.interface.server import launch
    launch(make_runner, lan=args.lan, port=args.port).serve_forever()


if __name__ == '__main__':
    main()
