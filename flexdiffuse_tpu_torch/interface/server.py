"""Web UI — dependency-free HTTP server with the reference's two-tab layout
(port of ``flexdiffuse_tpu/interface/server.py``).

A single-page app served from the Python stdlib: a **Sandbox** tab (guided
generation, all 16 controls with the reference's slider defaults,
interface/sandbox.py:70-180) and a **Compose** tab (background prompt +
entity table + style prompts, interface/composer.py:27-168); the page is
the JAX package's. The API is JSON-over-POST with base64 images; the model
Runner is a lazy singleton built by the factory given to :func:`launch`
(which picks the device: ``Runner(model_root=...)`` runs on the card unless
given ``device='cpu'``), guarded by a lock.

Generation requests serialise on ``_gen_lock``, so only one HTTP thread at
a time runs the model and touches the card. The optional ``Runner.gen``
keywords (hires fix, CFG interval from the page's ``cfg_from``/``cfg_to``,
CFG rescale, PAG; ``control_image``/``controlnet_scale`` and
``ip_image``/``ip_scale``; SDXL's ``refine_strength``) are forwarded only
when a client enables them, as the JAX handler forwards them. A control
image needs a Runner with a ControlNet (``--controlnet``) and an image
prompt one with an IP-Adapter and its encoder; without them the Runner's
``ValueError`` reaches the client as a JSON 500. The factory may build an
:class:`~flexdiffuse_tpu_torch.sdxl_runner.SDXLRunner` (``serve
--model-family sdxl``): the Sandbox tab drives its ``gen``, and the Compose
tab shows its ``compose`` error (composition is SD-1.x only) as a JSON 500.
"""
from __future__ import annotations

import base64
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from PIL import Image

log = logging.getLogger(__name__)

_runner = None
_runner_lock = threading.Lock()
# Generation requests serialize on one lock: the Runner's seed/key state is
# stateful and the chip is a serial resource anyway (the reference relied on
# Gradio's request queue for the same guarantee).
_gen_lock = threading.Lock()
_runner_factory: Optional[Callable] = None


def get_runner():
    global _runner
    with _runner_lock:
        if _runner is None:
            assert _runner_factory is not None, 'runner factory unset'
            _runner = _runner_factory()
        return _runner


def _b64_to_pil(data: Optional[str]) -> Optional[Image.Image]:
    if not data:
        return None
    raw = base64.b64decode(data.split(',')[-1])
    return Image.open(io.BytesIO(raw)).convert('RGB')


def _pil_to_b64(img: Image.Image) -> str:
    buf = io.BytesIO()
    img.save(buf, format='png')
    return 'data:image/png;base64,' + base64.b64encode(
        buf.getvalue()).decode()


def handle_generate(payload: dict) -> dict:
    """Sandbox generation (mirrors interface/sandbox.py:9-32 incl. the
    debug sample clamp at :16-19)."""
    p = dict(payload)
    samples = int(p.get('samples', 4))
    steps = int(p.get('steps', 30))
    debug = bool(p.get('debug', False))
    if debug and samples * steps > 100:
        samples = max(100 // steps, 1)
        log.info('Debug detected, forcing samples to %d', samples)
    guide_image = _b64_to_pil(p.get('guide_image'))
    guide = guide_image if guide_image is not None else \
        (p.get('guide_text') or None)
    control_image = _b64_to_pil(p.get('control_image'))
    ip_image = _b64_to_pil(p.get('ip_image'))
    imgs, grid = get_runner().gen(
        prompt=p.get('prompt', ''),
        init_image=_b64_to_pil(p.get('init_image')),
        guide=guide,
        init_size=(int(p.get('height', 512)), int(p.get('width', 512))),
        mapping_concepts=p.get('mapping_concepts', ''),
        guide_threshold_mult=float(p.get('threshold_mult', 0.25)),
        guide_threshold_floor=float(p.get('threshold_floor', 0.75)),
        guide_clustered=float(p.get('clustered', 0.15)),
        guide_linear=(float(p.get('linear_start', 0.1)),
                      float(p.get('linear_end', 0.5))),
        guide_max_guidance=float(p.get('max_guidance', 0.35)),
        guide_header_max=float(p.get('header_max', 0.0)),
        guide_mode=int(p.get('guide_mode', 1)),
        guide_reuse=bool(p.get('reuse', True)),
        strength=float(p.get('strength', 0.6)),
        steps=steps,
        guidance_scale=float(p.get('guidance_scale', 8)),
        samples=samples,
        seed=int(p.get('seed', 0)) or None,
        debug=debug,
        negative_prompt=p.get('negative_prompt', ''),
        mask=_b64_to_pil(p.get('mask')),
        long_prompt=bool(p.get('long_prompt', False)),
        weighted=bool(p.get('weighted', False)),
        # ControlNet and IP-Adapter: forwarded only with their image, so a
        # runner without them never sees the kwargs.
        **({'control_image': control_image,
            'controlnet_scale': float(p.get('controlnet_scale', 1.0))}
           if control_image is not None else {}),
        **({'ip_image': ip_image,
            'ip_scale': float(p.get('ip_scale', 1.0))}
           if ip_image is not None else {}),
        # SDXL-family only (base->refiner two-stage); forwarded only when a
        # client sends it so SD1.x runners never see the kwarg.
        **({'refine_strength': float(p['refine_strength'])}
           if 'refine_strength' in p else {}),
        # Highres fix (SD1.x Runner): forwarded only when enabled so
        # runners without the kwargs never see them.
        **({'hires_scale': float(p['hires_scale']),
            'hires_strength': float(p.get('hires_strength', 0.55))}
           if float(p.get('hires_scale', 0) or 0) > 1.0 else {}),
        # CFG interval: guidance only for progress in [lo, hi); forwarded
        # only when hi < 1 or lo > 0 keeps it inert for default clients.
        **({'cfg_interval': (float(p.get('cfg_from', 0.0)),
                             float(p.get('cfg_to', 1.0)))}
           if (float(p.get('cfg_from', 0) or 0) > 0
               or 0 < float(p.get('cfg_to', 1) or 1) < 1) else {}),
        # CFG rescale phi (Lin et al. 2023); inert at the 0 default.
        **({'guidance_rescale': float(p['guidance_rescale'])}
           if float(p.get('guidance_rescale', 0) or 0) > 0 else {}),
        # PAG (Ahn et al. 2024); inert at the 0 default (the runner
        # auto-enables the 'mid' perturbed layer on first use).
        **({'pag_scale': float(p['pag_scale'])}
           if float(p.get('pag_scale', 0) or 0) > 0 else {}))
    # The reference sandbox shows the batch gallery incl. its grid
    # (interface/sandbox.py:181-185); surface the composite grid too.
    return {'images': [_pil_to_b64(i) for i in imgs],
            'grid': _pil_to_b64(grid) if grid is not None else None}


def handle_compose(payload: dict) -> dict:
    """Compose generation (mirrors interface/composer.py:28-41)."""
    p = dict(payload)
    samples = int(p.get('samples', 4))
    steps = int(p.get('steps', 30))
    debug = bool(p.get('debug', False))
    if debug and samples * steps > 100:
        samples = max(100 // steps, 1)
    imgs, grid = get_runner().compose(
        bg_prompt=p.get('bg_prompt', ''),
        entities_df=p.get('entities', []),
        start_style=p.get('start_style', ''),
        end_style=p.get('end_style', ''),
        style_blend=(float(p.get('style_blend_start', 0.0)),
                     float(p.get('style_blend_end', 1.0))),
        init_image=_b64_to_pil(p.get('init_image')),
        batches=samples,
        strength=float(p.get('strength', 0.7)),
        steps=steps,
        guidance_scale=float(p.get('guidance_scale', 8.0)),
        init_size=(int(p.get('height', 512)), int(p.get('width', 512))),
        seed=int(p.get('seed', 1337)) or None,
        debug=debug,
        style_strength=float(p.get('style_strength', 0.0)))
    return {'images': [_pil_to_b64(i) for i in imgs],
            'grid': _pil_to_b64(grid) if grid is not None else None}


PAGE = r"""<!doctype html>
<html><head><title>FlexDiffuse TPU</title><style>
body{font-family:sans-serif;margin:0;background:#111;color:#eee}
nav{display:flex;gap:0;border-bottom:1px solid #333}
nav button{padding:12px 24px;background:#111;color:#eee;border:0;cursor:pointer;font-size:15px}
nav button.active{background:#222;border-bottom:2px solid #7af}
main{padding:16px;max-width:1100px;margin:auto}
fieldset{border:1px solid #333;margin:8px 0;display:grid;grid-template-columns:repeat(3,1fr);gap:8px}
label{display:flex;flex-direction:column;font-size:12px;color:#aaa}
input,textarea,select{background:#222;color:#eee;border:1px solid #444;padding:6px;border-radius:4px}
button.go{background:#36c;color:#fff;padding:10px 28px;border:0;border-radius:4px;font-size:15px;cursor:pointer}
#gallery img,#cgallery img{max-width:256px;margin:4px;border:1px solid #333}
table{border-collapse:collapse}td,th{border:1px solid #333;padding:4px}td input{width:70px}
.wide{grid-column:1/-1}
</style></head><body>
<nav><button id="tab-sandbox" class="active" onclick="tab('sandbox')">Sandbox</button>
<button id="tab-compose" onclick="tab('compose')">Compose</button></nav>
<main>
<section id="sandbox">
 <fieldset>
  <label class="wide">Prompt<textarea id="prompt" rows="1"></textarea></label>
  <label class="wide">Negative prompt<textarea id="negative_prompt" rows="1"></textarea></label>
  <label>Initial image<input type="file" id="init_image"></label>
  <label>Inpaint mask (white = regenerate)<input type="file" id="mask"></label>
  <label>Control image (needs --controlnet)<input type="file" id="control_image"></label>
  <label>Control scale<input id="controlnet_scale" type="number" step="0.05" value="1.0"></label>
  <label>IP-Adapter image (needs --ip-adapter)<input type="file" id="ip_image"></label>
  <label>IP scale<input id="ip_scale" type="number" step="0.05" value="1.0"></label>
  <label>Long prompt (chunked &gt;75 tokens)<input id="long_prompt" type="checkbox"></label>
  <label>Emphasis weighting ((word:1.3))<input id="weighted" type="checkbox"></label>
  <label>Guide image<input type="file" id="guide_image"></label>
  <label>Guide text<input id="guide_text"></label>
  <label>Mapping concepts<input id="mapping_concepts"></label>
  <label>Diffusion strength<input id="strength" type="number" step="0.01" value="0.6"></label>
  <label>Steps<input id="steps" type="number" value="30"></label>
  <label>Threshold mult<input id="threshold_mult" type="number" step="0.01" value="0.25"></label>
  <label>Threshold floor<input id="threshold_floor" type="number" step="0.01" value="0.75"></label>
  <label>Batches<input id="samples" type="number" value="4"></label>
  <label>Linear start<input id="linear_start" type="number" step="0.01" value="0.1"></label>
  <label>Linear end<input id="linear_end" type="number" step="0.01" value="0.5"></label>
  <label>Guidance scale<input id="guidance_scale" type="number" step="0.5" value="8"></label>
  <label>Clustered<input id="clustered" type="number" step="0.01" value="0.15"></label>
  <label>Seed<input id="seed" type="number" value="0"></label>
  <label>Max image guidance<input id="max_guidance" type="number" step="0.01" value="0.35"></label>
  <label>Header max<input id="header_max" type="number" step="0.01" value="0"></label>
  <label>Height<input id="height" type="number" step="64" value="512"></label>
  <label>Width<input id="width" type="number" step="64" value="512"></label>
  <label>Hires scale (0 = off)<input id="hires_scale" type="number" step="0.25" value="0"></label>
  <label>Hires strength<input id="hires_strength" type="number" step="0.01" value="0.55"></label>
  <label>CFG from<input id="cfg_from" type="number" step="0.05" value="0"></label>
  <label>CFG to (1 = always)<input id="cfg_to" type="number" step="0.05" value="1"></label>
  <label>CFG rescale (0 = off)<input id="guidance_rescale" type="number" step="0.05" value="0"></label>
  <label>PAG scale (0 = off)<input id="pag_scale" type="number" step="0.5" value="0"></label>
  <label>Mapping priority<select id="guide_mode"><option value="0">Text Order</option>
   <option value="1" selected>Best Fit</option><option value="2">Direct</option></select></label>
  <label>Reuse latents<input id="reuse" type="checkbox" checked></label>
  <label>Export debug images<input id="debug" type="checkbox"></label>
 </fieldset>
 <button class="go" onclick="generate()">Generate image</button>
 <div id="gallery"></div>
</section>
<section id="compose" style="display:none">
 <fieldset>
  <label class="wide">Background / main prompt<textarea id="bg_prompt" rows="1">A forest with a bear and a deer</textarea></label>
  <div class="wide"><table id="entities"><tr><th>Prompt</th><th>Left</th><th>Top</th><th>Width</th><th>Height</th><th>Strength</th></tr></table>
  <button onclick="addRow('',0,0,256,256,0.8)">+ row</button></div>
  <label>Start style<input id="start_style" value="Photo"></label>
  <label>End style<input id="end_style" value="Painting"></label>
  <label>Style blend start<input id="style_blend_start" type="number" step="0.01" value="0"></label>
  <label>Style blend end<input id="style_blend_end" type="number" step="0.01" value="1"></label>
  <label>Style strength (0 = reference behavior)<input id="style_strength" type="number" step="0.01" value="0"></label>
  <label>Initial image<input type="file" id="c_init_image"></label>
  <label>Batches<input id="c_samples" type="number" value="4"></label>
  <label>Strength<input id="c_strength" type="number" step="0.01" value="0.7"></label>
  <label>Steps<input id="c_steps" type="number" value="30"></label>
  <label>Guidance scale<input id="c_guidance_scale" type="number" step="0.5" value="8"></label>
  <label>Height<input id="c_height" type="number" step="64" value="512"></label>
  <label>Width<input id="c_width" type="number" step="64" value="512"></label>
  <label>Seed<input id="c_seed" type="number" value="1337"></label>
 </fieldset>
 <button class="go" onclick="compose()">Generate image</button>
 <div id="cgallery"></div>
</section>
</main>
<script>
function tab(t){for(const s of ['sandbox','compose']){
 document.getElementById(s).style.display=s===t?'':'none';
 document.getElementById('tab-'+s).classList.toggle('active',s===t);}}
function v(id){const e=document.getElementById(id);
 return e.type==='checkbox'?e.checked:e.value}
function file64(id){return new Promise(res=>{const f=document.getElementById(id).files[0];
 if(!f)return res(null);const r=new FileReader();r.onload=()=>res(r.result);r.readAsDataURL(f)})}
function addRow(p,l,t,w,h,s){const tr=document.createElement('tr');
 tr.innerHTML=`<td><input value="${p}"></td><td><input value="${l}"></td><td><input value="${t}"></td>
 <td><input value="${w}"></td><td><input value="${h}"></td><td><input value="${s}"></td>`;
 document.getElementById('entities').appendChild(tr)}
addRow('A bear in the forest',0,256,256,256,0.8);addRow('A deer in the forest',256,256,256,256,0.8);
async function post(url,body,gallery){const g=document.getElementById(gallery);
 g.innerHTML='<p>generating…</p>';
 const r=await fetch(url,{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 const d=await r.json();
 if(d.error){g.innerHTML='<pre>'+d.error+'</pre>';return}
 g.innerHTML=d.images.map(i=>`<img src="${i}">`).join('')+
  (d.grid&&d.images.length>1?`<div class="wide"><p>grid</p><img class="grid" src="${d.grid}"></div>`:'')}
async function generate(){const body={};
 for(const k of ['prompt','negative_prompt','guide_text','mapping_concepts','strength','steps','threshold_mult',
  'threshold_floor','samples','linear_start','linear_end','guidance_scale','clustered','seed',
  'max_guidance','header_max','height','width','guide_mode','reuse','debug',
  'hires_scale','hires_strength','cfg_from','cfg_to','guidance_rescale','pag_scale'])body[k]=v(k);
 body.init_image=await file64('init_image');body.guide_image=await file64('guide_image');
 body.mask=await file64('mask');
 body.control_image=await file64('control_image');
 body.controlnet_scale=document.getElementById('controlnet_scale').value;
 body.ip_image=await file64('ip_image');
 body.ip_scale=document.getElementById('ip_scale').value;
 body.long_prompt=document.getElementById('long_prompt').checked;
 body.weighted=document.getElementById('weighted').checked;
 post('/api/generate',body,'gallery')}
async function compose(){const rows=[...document.querySelectorAll('#entities tr')].slice(1)
 .map(tr=>[...tr.querySelectorAll('input')].map(i=>i.value));
 const body={entities:rows};
 for(const[k,id] of [['bg_prompt','bg_prompt'],['start_style','start_style'],['end_style','end_style'],
  ['style_blend_start','style_blend_start'],['style_blend_end','style_blend_end'],['style_strength','style_strength'],['samples','c_samples'],
  ['strength','c_strength'],['steps','c_steps'],['guidance_scale','c_guidance_scale'],
  ['height','c_height'],['width','c_width'],['seed','c_seed']])body[k]=v(id);
 body.init_image=await file64('c_init_image');
 post('/api/compose',body,'cgallery')}
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.info('%s ' + fmt, self.address_string(), *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ('/', '/index.html'):
            self._send(200, PAGE.encode(), 'text/html; charset=utf-8')
        elif self.path == '/api/health':
            self._send(200, b'{"ok": true}', 'application/json')
        else:
            self._send(404, b'not found', 'text/plain')

    def do_POST(self):
        n = int(self.headers.get('Content-Length', 0))
        try:
            payload = json.loads(self.rfile.read(n) or b'{}')
            if self.path == '/api/generate':
                with _gen_lock:
                    out = handle_generate(payload)
            elif self.path == '/api/compose':
                with _gen_lock:
                    out = handle_compose(payload)
            else:
                return self._send(404, b'{"error": "unknown endpoint"}',
                                  'application/json')
            self._send(200, json.dumps(out).encode(), 'application/json')
        except Exception as ex:  # surface errors to the UI like gradio does
            log.exception('request failed')
            self._send(500, json.dumps({'error': str(ex)}).encode(),
                       'application/json')


def launch(runner_factory: Callable, lan: bool = False,
           port: int = 7860) -> ThreadingHTTPServer:
    """Start the UI server (reference ``launch`` ui.py:24-57; ``--lan`` binds
    0.0.0.0). Returns the server; call ``serve_forever()`` to block."""
    global _runner_factory
    _runner_factory = runner_factory
    host = '0.0.0.0' if lan else '127.0.0.1'
    httpd = ThreadingHTTPServer((host, port), _Handler)
    log.info('FlexDiffuse UI (PyTorch port) on http://%s:%d', host, port)
    return httpd
