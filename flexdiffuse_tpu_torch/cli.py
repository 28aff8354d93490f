"""Command-line interface (port of ``flexdiffuse_tpu/cli.py``): the JAX
package's 8 subcommands and flags, plus ``--device``. Usage::

    python -m flexdiffuse_tpu_torch.cli convert --models ./models
    python -m flexdiffuse_tpu_torch.cli generate --models ./models \\
        --prompt "a deer" --guide guide.png --steps 30 --seed 1337
    python -m flexdiffuse_tpu_torch.cli compose --models ./models \
        --schema s.json
    python -m flexdiffuse_tpu_torch.cli train --models ./models --data DIR
    python -m flexdiffuse_tpu_torch.cli serve --models ./models [--lan]
    python -m flexdiffuse_tpu_torch.cli serve-api --models ./models

(or the ``flexdiffuse-tpu-torch`` script). ``generate``, ``compose``,
``edit``, ``train``, ``serve`` and ``serve-api`` run on the CUDA card
(``--device cuda``, the default, in bf16) and raise when there is none,
unless given ``--device cpu`` (fp32); nothing falls back to the CPU.

``convert`` writes the JAX package's msgpack caches beside the snapshots
(the port itself reads the snapshots directly); ``download`` fetches the
snapshots when ``huggingface_hub`` and the network are there.

The scheduler kinds and their switches (``--karras``, ``--v-prediction``,
``--zero-snr``, ``--timestep-spacing``), ``--model-family sd2`` (SD-2.1:
OpenCLIP-H text tower, 64-wide heads), ``--model-family sdxl`` (an
:class:`~flexdiffuse_tpu_torch.sdxl_runner.SDXLRunner` on the
``stable-diffusion-xl-base-1.0`` snapshot under ``--models``, or on
``--models`` itself, with ``--refiner``/``--refine-strength``; ``serve-api``
refuses it at start, as its dispatcher needs the SD-1.x Runner's encoder),
the pipeline knobs (``--freeu``,
``--vae-tile``, ``--deepcache``, ``--tome``, ``--pag-layers``) and
generate's ``--pag``, ``--cfg-interval``, ``--guidance-rescale`` and
``--hires-*`` do what they do in the JAX CLI, and so do the conditioning
models: ``--controlnet`` with ``--control-image``/``--controlnet-scale``,
``--ip-adapter`` (with ``--ip-encoder``) with ``--ip-image``/``--ip-scale``,
and ``edit`` (InstructPix2Pix on an 8-channel snapshot); for SD-1.x
``--ip-encoder-arch`` is accepted and unused, as in the JAX CLI.
``train --textual-inversion`` (with ``--init-token``, ``--num-vectors``,
``--style-templates``) trains an embedding as the JAX CLI does; ``train``
refuses ``--model-family sdxl`` with the JAX CLI's message. ``train
--data-parallel N`` (N > 1) starts N ranks (``parallel/launch.py``: NCCL,
one card each, or gloo with ``--device cpu``) that train data-parallel
over a ``make_mesh(model_parallel=1)``; rank 0 writes the output. With
fewer than N cards it raises before any model loads; textual inversion
ignores the flag, as in the JAX CLI. The JAX
parser's ``--compile-cache``/``--no-compile-cache`` are left out: they set
XLA's compilation cache (``utils/compile_cache.py``), which ROADMAP's "Do
not port" list names.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from flexdiffuse_tpu_torch import models, schedulers
from flexdiffuse_tpu_torch.config import RunConfig

# The geometry the model-running commands and ``convert`` build: SD-1.4 and
# CLIP ViT-L/14; with ``--model-family sd2`` SD-2.1 and its OpenCLIP-H text
# tower (the vision tower stays CLIP ViT-L/14's, as in the JAX CLI).
MODEL_CONFIGS = dict(text=models.CLIP_VIT_L14_TEXT,
                     vision=models.CLIP_VIT_L14_VISION,
                     unet=models.SD14_UNET, vae=models.SD14_VAE)
SD2_MODEL_CONFIGS = dict(text=models.OPENCLIP_H_TEXT,
                         vision=models.CLIP_VIT_L14_VISION,
                         unet=models.SD21_UNET, vae=models.SD21_VAE)
# train's unported flags, (dest, flag, the value that leaves the feature
# off, ROADMAP Queue 1 step): none left.
TRAIN_UNPORTED = ()


def _not_ported(what: str, step: int) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported yet (ROADMAP Queue 1 '
                               f'step {step})')


def refuse_unported(args, table=()) -> None:
    """Raise for the first flag of ``args`` (of ``table``) that asks for a
    feature the port does not have yet, naming its ROADMAP step."""
    for dest, flag, off, step in table:
        if getattr(args, dest, off) != off:
            raise _not_ported(flag, step)


def family_configs(args) -> dict:
    """The model geometry of ``--model-family`` (the parent's, carried in
    ``args.family_configs``, in a data-parallel rank)."""
    if getattr(args, 'family_configs', None) is not None:
        return args.family_configs
    if getattr(args, 'model_family', 'sd1') == 'sd2':
        return SD2_MODEL_CONFIGS
    return MODEL_CONFIGS


def scheduler_config(args):
    """The JAX CLI's SchedulerConfig from the scheduler switches (None when
    none is given)."""
    if not (getattr(args, 'karras', False) or
            getattr(args, 'v_prediction', False) or
            getattr(args, 'zero_snr', False) or
            getattr(args, 'timestep_spacing', None)):
        return None
    return schedulers.SchedulerConfig(
        kind=args.scheduler,
        use_karras_sigmas=getattr(args, 'karras', False),
        rescale_betas_zero_snr=getattr(args, 'zero_snr', False),
        timestep_spacing=getattr(args, 'timestep_spacing', None) or 'leading',
        prediction_type=('v_prediction' if getattr(args, 'v_prediction',
                                                   False) else 'epsilon'))


def resolve_device(name: str) -> torch.device:
    """``--device``: a CUDA device must be present (no fallback)."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}: no CUDA card is available; '
                           'pass --device cpu to run on the CPU')
    return device


def model_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU."""
    return torch.bfloat16 if device.type == 'cuda' else torch.float32


def _check(args, table=()) -> torch.device:
    """Everything a model-running command checks before it loads a model."""
    refuse_unported(args, table)
    return resolve_device(args.device)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--models', default='./models',
                   help='dir with HF snapshots of SD-1.4 and CLIP ViT-L/14')
    p.add_argument('--sd-model', default=None, metavar='REPO',
                   help='SD checkpoint repo id (default '
                        'CompVis/stable-diffusion-v1-4); its basename picks '
                        'the snapshot dir under --models — e.g. '
                        'runwayml/stable-diffusion-inpainting for native '
                        'inpainting (UNet input channels auto-adopt from '
                        "the snapshot's unet/config.json)")
    p.add_argument('--scheduler', default='pndm',
                   choices=('ddim', 'pndm', 'lms', 'euler', 'euler_a',
                            'dpmpp', 'lcm', 'ddpm', 'unipc', 'heun'))
    p.add_argument('--clip-skip', type=int, default=0, choices=(0, 1),
                   help='1 = condition on the penultimate CLIP layer')
    p.add_argument('--karras', action='store_true',
                   help='Karras sigma spacing (euler/euler_a/dpmpp/unipc/heun)')
    p.add_argument('--v-prediction', action='store_true',
                   help='v-parameterized model (use with --model-family sd2 '
                        'for SD2.1 768-v checkpoints)')
    p.add_argument('--zero-snr', action='store_true',
                   help='zero-terminal-SNR beta rescale (Lin et al. 2023) '
                        'for checkpoints trained with it; pair with '
                        '--v-prediction and consider --guidance-rescale 0.7')
    p.add_argument('--timestep-spacing', default=None,
                   choices=('leading', 'trailing'),
                   help="'trailing' starts inference at the last train "
                        'step (needed with --zero-snr to actually see pure '
                        'noise); default leading. ddim/ddpm only')
    p.add_argument('--model-family', default='sd1',
                   choices=('sd1', 'sd2', 'sdxl'),
                   help='checkpoint geometry: sd1 = SD1.x + CLIP ViT-L/14, '
                        'sd2 = SD2.x + OpenCLIP ViT-H text, sdxl = SDXL '
                        'base (+ --refiner); --models may point straight '
                        'at the SDXL snapshot')
    p.add_argument('--lora', action='append', default=[], metavar='PATH[:S]',
                   help='merge a kohya or PEFT LoRA (optional :scale, '
                        'repeatable)')
    p.add_argument('--embedding', action='append', default=[],
                   metavar='PATH[:TOKEN]',
                   help='load a textual-inversion embedding (optional '
                        ':token name, repeatable)')
    p.add_argument('--controlnet', default=None, metavar='PATH',
                   help='diffusers ControlNet snapshot (pair with '
                        '--control-image)')
    p.add_argument('--ip-adapter', default=None, metavar='PATH',
                   help='IP-Adapter checkpoint (base or Plus; pair with '
                        '--ip-image)')
    p.add_argument('--ip-encoder', default=None, metavar='DIR',
                   help='the IP-Adapter image-encoder snapshot '
                        '(CLIPVisionModelWithProjection; OpenCLIP ViT-H for '
                        'the SD-1.5 adapters)')
    p.add_argument('--ip-encoder-arch', default='vit-h',
                   choices=('vit-h', 'bigg'),
                   help='image-encoder tower for --ip-encoder with '
                        '--model-family sdxl (ip-adapter_sdxl.bin uses the '
                        'bigG tower; _vit-h checkpoints use ViT-H); SD-1.x '
                        'uses ViT-H')
    p.add_argument('--refiner', default=None, metavar='DIR',
                   help='SDXL refiner snapshot '
                        '(stable-diffusion-xl-refiner-1.0); enables the '
                        'two-stage base->refiner flow for --model-family '
                        'sdxl')
    p.add_argument('--refine-strength', type=float, default=0.3,
                   help='refiner img2img strength (fraction of the noise '
                        'schedule the refiner re-denoises; 0 disables)')
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument('--device', default='cuda',
                   help="torch device: 'cuda' (default; bf16, raises "
                        "without a card) or 'cpu' (fp32)")


def _sdxl_runner(args):
    """``SDXLRunner`` on ``--device`` (the JAX CLI's ``_sdxl_runner``): the
    ``stable-diffusion-xl-base-1.0`` snapshot under ``--models``, or
    ``--models`` itself; ``clip_root`` when ``clip-vit-large-patch14/`` is
    there; the refiner, LoRAs and IP-Adapter the flags name."""
    from flexdiffuse_tpu_torch.sdxl_runner import SDXLRunner
    from flexdiffuse_tpu_torch.weights.lora import parse_spec
    for flag in ('controlnet', 'embedding'):
        if getattr(args, flag, None):
            raise SystemExit(f'--{flag.replace("_", "-")} is not supported '
                             'with --model-family sdxl (SD1.x only)')
    device = resolve_device(args.device)
    root = os.path.join(args.models, 'stable-diffusion-xl-base-1.0')
    if not os.path.isdir(root):
        root = args.models  # --models may point straight at the snapshot
    clip = os.path.join(args.models, 'clip-vit-large-patch14')
    runner = SDXLRunner(root,
                        clip_root=clip if os.path.isdir(clip) else None,
                        scheduler=args.scheduler,
                        output_dir=getattr(args, 'out', './outputs'),
                        refiner_root=getattr(args, 'refiner', None),
                        device=device, dtype=model_dtype(device))
    for spec in getattr(args, 'lora', []):
        runner.apply_lora(*parse_spec(spec))
    if getattr(args, 'ip_adapter', None):
        runner.load_ip_adapter(args.ip_adapter,
                               getattr(args, 'ip_encoder', None),
                               encoder=getattr(args, 'ip_encoder_arch',
                                               'vit-h'))
    return runner


def _runner(args):
    """``Runner(model_root=--models)`` on ``--device``, with the LoRAs,
    ControlNet, IP-Adapter and textual inversions the flags name (in the
    JAX CLI's order); ``SDXLRunner`` for ``--model-family sdxl``."""
    from flexdiffuse_tpu_torch.runner import Runner
    from flexdiffuse_tpu_torch.weights.lora import parse_spec
    if getattr(args, 'model_family', 'sd1') == 'sdxl':
        return _sdxl_runner(args)
    device = resolve_device(args.device)
    run_cfg_kw = dict(output_dir=getattr(args, 'out', './outputs'))
    if getattr(args, 'sd_model', None):
        run_cfg_kw['sd_model'] = args.sd_model
    c = family_configs(args)
    runner = Runner(model_root=args.models, config=RunConfig(**run_cfg_kw),
                    scheduler=args.scheduler, dtype=model_dtype(device),
                    text_config=c['text'], vision_config=c['vision'],
                    unet_config=c['unet'], vae_config=c['vae'],
                    clip_skip=getattr(args, 'clip_skip', 0),
                    scheduler_config=scheduler_config(args), device=device)
    for spec in getattr(args, 'lora', []):
        runner.apply_lora(*parse_spec(spec))
    if getattr(args, 'controlnet', None):
        runner.load_controlnet(args.controlnet)
    if getattr(args, 'ip_adapter', None):
        runner.load_ip_adapter(args.ip_adapter,
                               image_encoder_dir=getattr(args, 'ip_encoder',
                                                         None))
    for spec in getattr(args, 'embedding', []):
        # 'path:token' unless the whole spec is itself an existing file.
        path, _, tok = spec.rpartition(':')
        if path and not os.path.exists(spec):
            runner.load_textual_inversion(path, token=tok)
        else:
            runner.load_textual_inversion(spec)
    return runner


def cmd_download(args) -> int:
    """Download HF snapshots (the reference's --dl flag, utils.py:59-66),
    then convert. Needs ``huggingface_hub`` and the network; says so on
    stderr and returns 1 without them."""
    cfg = RunConfig()
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        print('huggingface_hub is not installed; download the snapshots '
              'manually and run `convert`.', file=sys.stderr)
        return 1
    for repo in (cfg.sd_model, cfg.clip_model):
        dest = os.path.join(args.models, repo.split('/')[-1])
        print(f'downloading {repo} -> {dest}')
        try:
            snapshot_download(repo, local_dir=dest)
        except Exception as ex:
            print(f'download failed ({type(ex).__name__}): no network '
                  'egress? Place the snapshots manually and run `convert`.',
                  file=sys.stderr)
            return 1
    return cmd_convert(args)


def cmd_convert(args) -> int:
    """Write the JAX package's msgpack caches beside the snapshots."""
    from flexdiffuse_tpu_torch.weights import load
    cfg = RunConfig()
    sd_dir, clip_dir = load.snapshot_dirs(args.models, cfg.sd_model,
                                          cfg.clip_model)
    c = MODEL_CONFIGS
    print(f'converted CLIP -> '
          f'{load.write_clip_cache(clip_dir, c["text"], c["vision"])}')
    print(f'converted SD   -> '
          f'{load.write_sd_cache(sd_dir, c["unet"], c["vae"])}')
    return 0


def _apply_pipe_options(runner, args) -> None:
    """The pipeline knobs of generate, serve and serve-api (the JAX CLI's):
    FreeU, tiled VAE, DeepCache, ToMe and the PAG layers."""
    freeu = getattr(args, 'freeu', '')
    if freeu:
        if freeu.strip().lower() == 'on':
            runner.enable_freeu()
        else:
            vals = [float(v) for v in freeu.split(',')]
            if len(vals) != 4:
                raise SystemExit("--freeu expects 'b1,b2,s1,s2' or 'on'")
            runner.enable_freeu(*vals)
    if getattr(args, 'vae_tile', 0):
        runner.enable_vae_tiling(args.vae_tile)
    if getattr(args, 'deepcache', 0):
        runner.enable_deepcache(args.deepcache)
    tome = getattr(args, 'tome', '')
    if tome:
        vals = tome.split(',')
        if len(vals) not in (1, 2):
            raise SystemExit("--tome expects 'RATIO' or 'RATIO,MIN_SEQ'")
        runner.enable_tome(float(vals[0]),
                           *([int(vals[1])] if len(vals) == 2 else []))
    pag_layers = getattr(args, 'pag_layers', '')
    if pag_layers:
        runner.enable_pag(tuple(s.strip() for s in pag_layers.split(',')
                                if s.strip()))


def _runner_with_options(args):
    runner = _runner(args)
    _apply_pipe_options(runner, args)
    return runner


def cmd_generate(args) -> int:
    from PIL import Image
    _check(args)
    runner = _runner_with_options(args)
    guide = None
    if args.guide:
        guide = Image.open(args.guide) if os.path.exists(args.guide) \
            else args.guide  # a path → image guide; otherwise text guide
    init = Image.open(args.init_image) if args.init_image else None
    mask = Image.open(args.mask) if args.mask else None
    control = Image.open(args.control_image) if args.control_image else None
    ip_img = Image.open(args.ip_image) if args.ip_image else None
    imgs, grid = runner.gen(
        prompt=args.prompt, init_image=init, guide=guide,
        init_size=(args.height, args.width),
        mapping_concepts=args.concepts,
        guide_threshold_mult=args.threshold_mult,
        guide_threshold_floor=args.threshold_floor,
        guide_clustered=args.clustered,
        guide_linear=(args.linear_start, args.linear_end),
        guide_max_guidance=args.max_guidance,
        guide_header_max=args.header_max, guide_mode=args.mode,
        guide_reuse=not args.no_reuse, strength=args.strength,
        steps=args.steps, guidance_scale=args.guidance_scale,
        samples=args.samples, seed=args.seed, debug=args.debug,
        negative_prompt=args.negative_prompt, mask=mask,
        control_image=control, controlnet_scale=args.controlnet_scale,
        ip_image=ip_img, ip_scale=args.ip_scale,
        long_prompt=args.long_prompt, weighted=args.weighted,
        cfg_interval=(tuple(args.cfg_interval) if args.cfg_interval
                      else None),
        guidance_rescale=args.guidance_rescale, pag_scale=args.pag,
        **({'refine_strength': args.refine_strength}
           if args.model_family == 'sdxl' else
           {'hires_scale': args.hires_scale,
            'hires_strength': args.hires_strength,
            'hires_steps': args.hires_steps}))
    print(f'{len(imgs)} image(s) written to {runner.output_dir}')
    return 0


def cmd_compose(args) -> int:
    from flexdiffuse_tpu_torch.composition import Schema
    _check(args)
    with open(args.schema) as f:
        schema = Schema.from_json(f.read())
    runner = _runner(args)
    imgs, grid = runner.compose(
        bg_prompt=schema.background_prompt,
        entities_df=[[e.prompt, e.offset[0], e.offset[1], e.size[0],
                      e.size[1], e.blend] for e in schema.entities],
        start_style=schema.style_start_prompt,
        end_style=schema.style_end_prompt,
        style_blend=schema.style_blend, batches=args.samples,
        strength=args.strength, steps=args.steps,
        guidance_scale=args.guidance_scale,
        init_size=(args.height, args.width), seed=args.seed,
        debug=args.debug)
    print(f'{len(imgs)} image(s) written to {runner.output_dir}')
    return 0


def cmd_edit(args) -> int:
    """Instruction-based image editing (InstructPix2Pix): needs an
    8-channel edit snapshot (e.g. timbrooks/instruct-pix2pix, named with
    ``--sd-model``); the UNet's input width comes from its
    ``unet/config.json``."""
    from PIL import Image
    if getattr(args, 'pag_layers', ''):
        # As the JAX CLI: the IP2P guidance path has no PAG. Checked before
        # anything else.
        raise SystemExit('--pag-layers does not apply to edit (the '
                         'InstructPix2Pix guidance path has no PAG); '
                         'remove the flag')
    _check(args)
    runner = _runner_with_options(args)
    imgs, grid = runner.edit(
        prompt=args.prompt, image=Image.open(args.image), steps=args.steps,
        guidance_scale=args.guidance_scale,
        image_guidance_scale=args.image_guidance_scale,
        negative_prompt=args.negative_prompt, samples=args.samples,
        seed=args.seed, debug=args.debug,
        guidance_rescale=args.guidance_rescale)
    print(f'{len(imgs)} image(s) written to {runner.output_dir}')
    return 0


def _train_models(args, device: torch.device):
    """(CLIP encoder, UNet, VAE) from the snapshots under ``--models``: the
    text tower and VAE in the device's dtype, the UNet in fp32 for full
    fine-tuning (fp32 weights and AdamW; bf16 autocast on the card) and in
    the device's dtype under LoRA factors (which stay fp32)."""
    from flexdiffuse_tpu_torch.encode import CLIPEncoder
    from flexdiffuse_tpu_torch.text.tokenizer import CLIPTokenizer
    from flexdiffuse_tpu_torch.weights import load
    cfg = RunConfig()
    sd_dir, clip_dir = load.snapshot_dirs(args.models, cfg.sd_model,
                                          cfg.clip_model)
    c = family_configs(args)
    dtype = model_dtype(device)
    text_sd, _ = load.load_clip(clip_dir)
    unet_sd, vae_sd = load.load_sd(sd_dir)
    text = load.instantiate(models.CLIPTextModel, c['text'], text_sd, device,
                            dtype)
    encoder = CLIPEncoder(text, None, CLIPTokenizer.from_dir(clip_dir),
                          clip_skip=args.clip_skip)
    unet = load.instantiate(models.UNet2DCondition, c['unet'], unet_sd,
                            device, torch.float32 if args.full else dtype)
    if args.full:
        unet.requires_grad_(True)
    vae = load.instantiate(models.AutoencoderKL, c['vae'], vae_sd, device,
                           dtype)
    return encoder, unet, vae


def cmd_train(args) -> int:
    """Fine-tune on a folder of images: LoRA by default, ``--full`` for the
    whole UNet, DreamBooth prior preservation with ``--class-data``."""
    if getattr(args, 'model_family', 'sd1') == 'sdxl':
        # As the JAX CLI, before anything loads (its parser, like this
        # one, offers only sd1 and sd2; a namespace can still carry it).
        raise SystemExit('train: SDXL fine-tuning is not wired into the CLI '
                         'yet — use the training library API directly')
    device = _check(args, TRAIN_UNPORTED)
    if args.data_parallel > 1 and not args.textual_inversion:
        from flexdiffuse_tpu_torch.parallel import launch
        launch.check_cards(args.data_parallel, device.type)
        ranks = argparse.Namespace(**vars(args),
                                   family_configs=family_configs(args))
        launch.spawn(_train_rank, args.data_parallel, device=device.type,
                     args=(ranks,))
        print(f'trained weights written to {_train_out(args)}')
        return 0
    return _train(args, device)


def _train_out(args) -> str:
    """``--out``, or the default output of the training mode."""
    if args.textual_inversion:
        return args.out or 'embedding.safetensors'
    return args.out or ('finetuned_unet.msgpack' if args.full
                        else 'lora.safetensors')


def _train_rank(rank: int, world: int, args) -> None:
    """One rank of ``train --data-parallel``: the models on its device,
    data-parallel over every rank; rank 0 writes the output."""
    from flexdiffuse_tpu_torch.parallel import make_mesh
    device = torch.device('cuda', rank) if args.device.startswith('cuda') \
        else torch.device('cpu')
    _train(args, device, make_mesh(model_parallel=1), quiet=rank > 0)


def _train(args, device: torch.device, mesh=None, quiet: bool = False
           ) -> int:
    """``train`` on ``device`` (over ``mesh`` when given)."""
    from flexdiffuse_tpu_torch import training
    encoder, unet, vae = _train_models(args, device)
    # SD-2.x trains against v, as the JAX CLI.
    v_pred = args.v_prediction or args.model_family == 'sd2'
    tcfg = training.TrainConfig(learning_rate=args.lr,
                                prediction_type=('v_prediction' if v_pred
                                                 else 'epsilon'),
                                snr_gamma=args.snr_gamma,
                                remat=args.remat,
                                grad_accum=args.grad_accum,
                                ema_decay=args.ema_decay)
    out = _train_out(args)
    if args.textual_inversion:
        paths = [p for p, _ in training.find_items(
            args.data, default_caption='x')]
        templates = (training.STYLE_TEMPLATES if args.style_templates
                     else training.OBJECT_TEMPLATES)
        training.train_textual_inversion(
            encoder.text_model, encoder.tokenizer, unet, vae, paths,
            args.textual_inversion, initializer_token=args.init_token,
            num_vectors=args.num_vectors, templates=templates, cfg=tcfg,
            steps=args.steps, batch_size=args.batch_size,
            resolution=args.resolution, seed=args.seed or 0, save_path=out)
        print(f'trained weights written to {out}')
        return 0
    items = training.find_items(args.data, default_caption=args.caption)
    ds = training.encode_dataset(items, vae, encoder,
                                 resolution=args.resolution)
    seed = args.seed if args.seed is not None else 0
    if args.class_data:
        # DreamBooth prior preservation: class images must exist already
        # (pre-generate with `generate --prompt "<class prompt>"` or
        # training.generate_class_images).
        cds = training.encode_dataset(
            training.find_items(args.class_data,
                                default_caption=args.class_caption),
            vae, encoder, resolution=args.resolution)
        mode = 'full' if args.full else 'lora'
        training.train_dreambooth(
            unet, ds, cds, cfg=tcfg, prior_weight=args.prior_weight,
            mode=mode, rank=args.rank, steps=args.steps,
            batch_size=args.batch_size, seed=seed, mesh=mesh, save_path=out)
    elif args.full:
        training.train_full(unet, ds, tcfg, steps=args.steps,
                            batch_size=args.batch_size, seed=seed, mesh=mesh,
                            save_path=out,
                            checkpoint_dir=args.checkpoint_dir,
                            checkpoint_every=args.checkpoint_every)
    else:
        training.train_lora(unet, ds, tcfg, rank=args.rank,
                            steps=args.steps, batch_size=args.batch_size,
                            seed=seed, mesh=mesh, save_path=out,
                            checkpoint_dir=args.checkpoint_dir,
                            checkpoint_every=args.checkpoint_every)
    if not quiet:
        print(f'trained weights written to {out}')
    return 0


def _add_pipe_option_args(p) -> None:
    """The JAX CLI's post-construction pipeline knobs (generate/edit/serve/
    serve-api; :func:`_apply_pipe_options`)."""
    p.add_argument('--freeu', default='',
                   help="FreeU 'b1,b2,s1,s2' (empty = off; 'on' = the "
                        "SD1.x defaults 1.5,1.6,0.9,0.2)")
    p.add_argument('--vae-tile', type=int, default=0,
                   help='tiled VAE decode/encode in N-latent-unit tiles '
                        '(64 = 512 px). 0 = off')
    p.add_argument('--deepcache', type=int, default=0,
                   help='DeepCache interval N: full UNet every Nth step, '
                        'the shallow levels around the cached deep feature '
                        'in between (2-3: the published sweet spot). '
                        '0 = off')
    p.add_argument('--tome', default='',
                   help="ToMe token merging 'RATIO' or 'RATIO,MIN_SEQ' "
                        '(default MIN_SEQ 4096); empty = off')
    p.add_argument('--pag-layers', default='',
                   help="PAG perturbed layers, comma-separated name "
                        "prefixes ('mid', 'down_1', 'up_2_attn_1'); 'mid' "
                        'when --pag is used without it')


def cmd_serve(args) -> int:
    from flexdiffuse_tpu_torch.interface.server import launch
    _check(args)
    launch(lambda: _runner_with_options(args), lan=args.lan,
           port=args.port).serve_forever()
    return 0


def cmd_serve_api(args) -> int:
    from flexdiffuse_tpu_torch.serving import launch
    if args.model_family == 'sdxl':
        # The dispatcher encodes prompts with the SD-1.x Runner's encoder,
        # which SDXLRunner has not (nor has the JAX API a path for it).
        raise SystemExit('serve-api does not serve --model-family sdxl; use '
                         '`serve` (the web UI) or `generate`')
    _check(args)
    launch(lambda: _runner_with_options(args), port=args.port, lan=args.lan,
           max_batch_rows=args.max_batch, max_wait_ms=args.max_wait_ms,
           fixed_rows=args.deterministic).serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser without its compilation-cache pair, with
    ``--device`` on every model-running subcommand."""
    parser = argparse.ArgumentParser(prog='flexdiffuse_tpu_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('convert', help='write the JAX package\'s msgpack '
                                       'caches beside the HF snapshots')
    p.add_argument('--models', default='./models')
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser('download',
                       help='download HF snapshots then convert (needs '
                            'network egress)')
    p.add_argument('--models', default='./models')
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser('generate', help='guided generation')
    _add_model_args(p)
    p.add_argument('--prompt', default='')
    p.add_argument('--negative-prompt', default='')
    p.add_argument('--guide', default='',
                   help='guide image path or guide text')
    p.add_argument('--init-image', default='')
    p.add_argument('--mask', default='',
                   help='inpainting mask image (white = regenerate)')
    p.add_argument('--control-image', default='',
                   help='ControlNet conditioning image (needs --controlnet)')
    p.add_argument('--controlnet-scale', type=float, default=1.0)
    p.add_argument('--ip-image', default='',
                   help='IP-Adapter image prompt (needs --ip-adapter and '
                        '--ip-encoder)')
    p.add_argument('--ip-scale', type=float, default=1.0)
    p.add_argument('--long-prompt', action='store_true',
                   help='chunked encoding for >75-token prompts (A1111 '
                        'convention; with --guide, the tween applies to the '
                        'first 77-token window)')
    _add_pipe_option_args(p)
    p.add_argument('--hires-scale', type=float, default=0.0,
                   help='two-pass highres fix: generate at --height/'
                        '--width, upscale the latents by this factor, '
                        'refine with img2img. 0 = off')
    p.add_argument('--hires-strength', type=float, default=0.55)
    p.add_argument('--hires-steps', type=int, default=None)
    p.add_argument('--weighted', action='store_true',
                   help='parse A1111 emphasis syntax — (word:1.3), [word], '
                        'BREAK — in prompt and negative prompt; subsumes '
                        '--long-prompt')
    p.add_argument('--cfg-interval', type=float, nargs=2, default=None,
                   metavar=('LO', 'HI'),
                   help='classifier-free guidance only for denoise '
                        'progress in [LO, HI] (cond-only at half the UNet '
                        'batch outside), e.g. 0.0 0.6')
    p.add_argument('--guidance-rescale', type=float, default=0.0,
                   help='CFG rescale phi (Lin et al. 2023); 0.7 for '
                        'zero-SNR checkpoints. 0 = off')
    p.add_argument('--pag', type=float, default=0.0, metavar='SCALE',
                   help='perturbed-attention guidance scale (~3.0; '
                        "layers from --pag-layers, default 'mid'). 0 = off")
    p.add_argument('--concepts', default='')
    p.add_argument('--out', default='./outputs')
    p.add_argument('--height', type=int, default=512)
    p.add_argument('--width', type=int, default=512)
    p.add_argument('--threshold-mult', type=float, default=0.25)
    p.add_argument('--threshold-floor', type=float, default=0.75)
    p.add_argument('--clustered', type=float, default=0.15)
    p.add_argument('--linear-start', type=float, default=0.1)
    p.add_argument('--linear-end', type=float, default=0.5)
    p.add_argument('--max-guidance', type=float, default=0.35)
    p.add_argument('--header-max', type=float, default=0.0)
    p.add_argument('--mode', type=int, default=1,
                   help='0=text order, 1=best fit, 2=direct')
    p.add_argument('--no-reuse', action='store_true')
    p.add_argument('--strength', type=float, default=0.6)
    p.add_argument('--steps', type=int, default=30)
    p.add_argument('--guidance-scale', type=float, default=8.0)
    p.add_argument('--samples', type=int, default=4)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--debug', action='store_true')
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser('edit',
                       help='instruction-based image editing '
                            '(InstructPix2Pix)')
    _add_model_args(p)
    p.add_argument('--prompt', required=True, help='edit instruction, '
                   'e.g. "make it winter"')
    p.add_argument('--image', required=True, help='image to edit')
    p.add_argument('--negative-prompt', default='')
    p.add_argument('--steps', type=int, default=30)
    p.add_argument('--guidance-scale', type=float, default=7.5,
                   help='text CFG scale (published IP2P default 7.5)')
    p.add_argument('--image-guidance-scale', type=float, default=1.5,
                   help='image CFG scale (published default 1.5)')
    p.add_argument('--guidance-rescale', type=float, default=0.0)
    p.add_argument('--samples', type=int, default=1)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--out', default='./outputs')
    p.add_argument('--debug', action='store_true')
    _add_pipe_option_args(p)
    p.set_defaults(fn=cmd_edit)

    p = sub.add_parser('compose', help='regional composition from a schema')
    _add_model_args(p)
    p.add_argument('--schema', required=True, help='Schema json file')
    p.add_argument('--out', default='./outputs')
    p.add_argument('--height', type=int, default=512)
    p.add_argument('--width', type=int, default=512)
    p.add_argument('--strength', type=float, default=0.7)
    p.add_argument('--steps', type=int, default=30)
    p.add_argument('--guidance-scale', type=float, default=8.0)
    p.add_argument('--samples', type=int, default=4)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--debug', action='store_true')
    p.set_defaults(fn=cmd_compose)

    p = sub.add_parser('train', help='fine-tune on a folder of images '
                                     '(LoRA by default)')
    p.add_argument('--models', default='./models',
                   help='dir with the HF snapshots')
    p.add_argument('--model-family', default='sd1', choices=('sd1', 'sd2'),
                   help='sd2 = SD2.x + OpenCLIP ViT-H text; trains against '
                        'v')
    p.add_argument('--clip-skip', type=int, default=0, choices=(0, 1))
    p.add_argument('--v-prediction', action='store_true',
                   help='train against the v-prediction objective')
    p.add_argument('--data', required=True,
                   help='dataset dir: images + same-stem .txt captions or '
                        'metadata.jsonl; captionless folders use --caption')
    p.add_argument('--caption', default='',
                   help='caption for images without one (DreamBooth-style '
                        'single-concept training)')
    p.add_argument('--resolution', type=int, default=512)
    p.add_argument('--full', action='store_true',
                   help='fine-tune the whole UNet instead of LoRA factors')
    p.add_argument('--textual-inversion', default='', metavar='PLACEHOLDER',
                   help='train a textual-inversion embedding for this '
                        'placeholder token (e.g. "<my-concept>") instead '
                        'of LoRA/full')
    p.add_argument('--init-token', default='',
                   help='textual inversion: single token whose embedding '
                        'seeds the new vectors')
    p.add_argument('--num-vectors', type=int, default=1,
                   help='textual inversion: vectors per concept')
    p.add_argument('--style-templates', action='store_true',
                   help='textual inversion: use the style (painting) '
                        'template set instead of the object one')
    p.add_argument('--remat', default='none',
                   choices=('none', 'dots', 'full'),
                   help='activation rematerialization (memory for compute)')
    p.add_argument('--grad-accum', type=int, default=1,
                   help='micro-batches per optimizer step')
    p.add_argument('--ema-decay', type=float, default=0.0,
                   help='EMA of trained params (e.g. 0.9999; 0 = off)')
    p.add_argument('--class-data', default='',
                   help='DreamBooth prior preservation: folder of class '
                        'images (pre-generate with the generate command)')
    p.add_argument('--class-caption', default='',
                   help='caption for class images without sidecars (e.g. '
                        '"a photo of a dog")')
    p.add_argument('--prior-weight', type=float, default=1.0,
                   help='DreamBooth prior-preservation loss weight')
    p.add_argument('--rank', type=int, default=8, help='LoRA rank')
    p.add_argument('--steps', type=int, default=500)
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--snr-gamma', type=float, default=0.0,
                   help='min-SNR loss weighting (0 = uniform)')
    p.add_argument('--data-parallel', type=int, default=1,
                   help='shard batches over this many devices (one rank '
                        'each; with --device cpu, gloo ranks)')
    p.add_argument('--checkpoint-dir', default='',
                   help='checkpoint directory; if it already holds a '
                        'checkpoint, training resumes from it')
    p.add_argument('--checkpoint-every', type=int, default=100,
                   help='optimizer steps between checkpoints')
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--out', default='',
                   help='output path (default lora.safetensors / '
                        'finetuned_unet.msgpack)')
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser('serve', help='launch the web UI')
    _add_model_args(p)
    _add_pipe_option_args(p)
    p.add_argument('--lan', action='store_true')
    p.add_argument('--port', type=int, default=7860)
    p.add_argument('--out', default='./outputs')
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser('serve-api',
                       help='launch the batched JSON serving API')
    _add_model_args(p)
    _add_pipe_option_args(p)
    p.add_argument('--lan', action='store_true')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--max-batch', type=int, default=8,
                   help='max fused rows per device dispatch')
    p.add_argument('--max-wait-ms', type=float, default=30.0,
                   help='batching window before a partial batch dispatches')
    p.add_argument('--deterministic', action='store_true',
                   help='pad every dispatch to --max-batch rows: one batch '
                        'shape, bitwise-reproducible results regardless of '
                        'batch composition')
    p.add_argument('--out', default='./outputs')
    p.set_defaults(fn=cmd_serve_api)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
