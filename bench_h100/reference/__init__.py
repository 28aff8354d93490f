"""The benchmark's plain reference: Stable Diffusion's parts written from
the published architectures in plain PyTorch, run in fp32 with TF32 off.

- ``text``: the CLIP ViT-L/14 and OpenCLIP ViT-H/14 text transformers;
- ``unet``: the SD-1.x/2.x conditional UNet (diffusers'
  ``UNet2DConditionModel`` layout and parameter names);
- ``vae``: the AutoencoderKL decoder;
- ``samplers``: PNDM in PLMS mode and DDIM (ε or v prediction), with
  classifier-free guidance;
- ``train``: the noise-prediction loss, LoRA over a frozen UNet, and
  AdamW with global-norm clipping.

Weights come in as a dict keyed by diffusers' names, made by the
benchmark from the seed (``bench_h100.seeded``). Every op fetches its
weight through :class:`~bench_h100.reference.ops.Ops` with the shape it
expects, so a dry run on the meta device lists the parameters the
reference reads and counts its FLOPs. This package imports nothing of the
program under test.
"""
