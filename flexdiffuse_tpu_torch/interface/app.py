"""FlexDiffuse web UI app entry (port of ``flexdiffuse_tpu/interface/app.py``).

Usage: ``python -m flexdiffuse_tpu_torch [--models DIR] [--lan] [--port N]
[--scheduler S] [--lora PATH[:S]] [--device cuda|cpu]``. The model loads on
the CUDA card (bf16) at the first request and the command raises at once
when there is no card, unless given ``--device cpu`` (fp32). ``--dl``
allows downloads as in the JAX app (the port reads snapshots already on
disk under ``--models``). Flags whose features the port does not have yet
(``--karras``, ``--v-prediction``, ``--model-family sd2``: ROADMAP Queue 1
step 9; an unported ``--scheduler`` kind) raise naming their step. The JAX
app's ``--compile-cache``/``--no-compile-cache`` are left out: they set
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
                                 'dpmpp', 'ddpm', 'unipc'),
                        help='ported: ddim, pndm, lms (the others: ROADMAP '
                             'step 9)')
    parser.add_argument('--karras', action='store_true',
                        help='Karras sigma spacing (not ported: step 9)')
    parser.add_argument('--v-prediction', action='store_true',
                        help='v-parameterized model (not ported: step 9)')
    parser.add_argument('--model-family', default='sd1',
                        choices=('sd1', 'sd2'),
                        help='checkpoint geometry: sd1 = SD1.x + ViT-L/14 '
                             '(sd2: step 9)')
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
    cli.refuse_unported(args)
    device = cli.resolve_device(args.device)

    def make_runner():
        from flexdiffuse_tpu_torch.config import RunConfig
        from flexdiffuse_tpu_torch.runner import Runner
        from flexdiffuse_tpu_torch.weights.lora import parse_spec
        runner = Runner(model_root=args.models,
                        config=RunConfig(local_only=not args.download),
                        scheduler=args.scheduler,
                        dtype=cli.model_dtype(device), device=device)
        for spec in args.lora:
            runner.apply_lora(*parse_spec(spec))
        return runner

    from flexdiffuse_tpu_torch.interface.server import launch
    launch(make_runner, lan=args.lan, port=args.port).serve_forever()


if __name__ == '__main__':
    main()
