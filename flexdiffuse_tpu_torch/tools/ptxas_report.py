"""What ptxas makes of each kernel of one of the port's CUDA sources.

    python -m flexdiffuse_tpu_torch.tools.ptxas_report \
        [--source flash_backward] [--match REGEX] [--raw PATH] \
        [--sass REGEX]

Compiles the source's build parts at once, as ``ops.flash_attention.build``
does, with ``-Xptxas -v`` added, and prints one JSON line per entry
function whose demangled name matches ``--match``: its registers per
thread, shared memory, stack frame, spill stores and loads, and the ptxas
diagnostics naming it (such as C7512, wgmma serialised for registers;
C7513/C7514, serialised for a register written or a wgmma issued under a
branch), then a line of counts, with how many shown kernels spill and how
many have a wgmma diagnostic (``spilled``, ``serialised``); ``--raw`` also
writes ptxas's whole report; ``--sass`` counts, in each shown kernel's
SASS (``cuobjdump -sass`` of the compiled objects), the instructions
matching a regular expression, by opcode (``--sass 'MUFU[.][A-Z0-9_.]+'``:
the exponentials). Writes nothing into the build directory. Needs
``nvcc`` (no card). T1's and T6's Hopper kernels: ``--source
flash_variants_sm90 --match chains``; T4's and T5's ``--match
'chains.*Tt'``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn

SOURCES = {'flash_attention': (fa.SOURCE, fa.BUILD_PARTS),
           'flash_backward': (fb.SOURCE, fb.BUILD_PARTS),
           'group_norm': (gn.SOURCE, 1),
           'flash_variants': (fv.SOURCE, fv.BUILD_PARTS),
           'flash_variants_sm90': (fv.SM90_SOURCE, fv.SM90_BUILD_PARTS)}

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r'Function properties for (\w+)')
_FRAME = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                    r'(\d+) bytes spill loads')
_USED = re.compile(r'Used (\d+) registers')
_SMEM = re.compile(r'(\d+) bytes smem')
# A diagnostic that names its function, as ptxas prints it under 'info'
# or 'warning': "(C7512) Potential Performance Loss: ... for the function
# '<mangled>'" (some say "in the function").
_WARN = re.compile(r"(\(C\d+\).*?) (?:for|in) the function '(\w+)'")


_FUNCTION = re.compile(r'\n\s*Function : (\w+)')


def count_sass(sass: str, pattern: str) -> dict:
    """``{mangled name: {opcode: count}}`` of the instructions matching
    ``pattern`` in each function of ``cuobjdump -sass``'s output."""
    pieces = _FUNCTION.split(sass)
    return {name: dict(collections.Counter(re.findall(pattern, body)))
            for name, body in zip(pieces[1::2], pieces[2::2])}


def sass_counts(obj: str, pattern: str) -> dict:
    """:func:`count_sass` of object ``obj``'s SASS."""
    tool = shutil.which('cuobjdump') or os.path.join(
        os.path.dirname(fa._nvcc()), 'cuobjdump')
    return count_sass(subprocess.run([tool, '-sass', obj],
                                     capture_output=True, text=True,
                                     check=True).stdout, pattern)


def compile_verbose(source, parts: int, sass: str = '') -> tuple:
    """ptxas's report for every part of ``source``, in part order, and
    with ``sass`` each function's :func:`sass_counts` of it."""
    nvcc = fa._nvcc()
    flags = [f for f in fa.NVCC_FLAGS if f != '-shared']
    with tempfile.TemporaryDirectory() as tmp:
        def one(p: int) -> tuple:
            defs = ([f'-DBUILD_PART={p}', f'-DBUILD_PARTS={parts}']
                    if parts > 1 else [])
            obj = os.path.join(tmp, f'part{p}.o')
            proc = subprocess.run(
                [nvcc, *flags, '-Xptxas', '-v', '-c', *defs, '-o', obj,
                 str(source)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {source.name} part {p}:'
                                   f'\n{proc.stderr}')
            return (proc.stdout + proc.stderr,
                    sass_counts(obj, sass) if sass else {})
        with ThreadPoolExecutor(parts) as pool:
            done = list(pool.map(one, range(parts)))
    counts = {}
    for _, c in done:
        counts.update(c)
    return ''.join(r for r, _ in done), counts


def demangle(names) -> dict:
    """Mangled → demangled names (``cu++filt`` or ``c++filt``; unchanged
    when neither is there)."""
    names = sorted(set(names))
    tool = shutil.which('cu++filt') or os.path.join(
        os.path.dirname(fa._nvcc()), 'cu++filt')
    if not os.path.exists(tool):
        tool = shutil.which('c++filt')
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input='\n'.join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def parse(report: str) -> dict:
    """``{mangled name: {registers, smem_bytes, stack_bytes, spill_stores,
    spill_loads, warnings}}`` from ptxas's ``-v`` output."""
    kernels: dict = {}
    current = None
    for line in report.splitlines():
        m = _ENTRY.search(line) or _PROPS.search(line)
        if m:
            current = kernels.setdefault(m.group(1), dict(warnings=[]))
            continue
        m = _WARN.search(line)
        if m:
            kernels.setdefault(m.group(2), dict(warnings=[]))[
                'warnings'].append(m.group(1))
            continue
        if current is None:
            continue
        m = _FRAME.search(line)
        if m:
            current.update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            current['registers'] = int(m.group(1))
            smem = _SMEM.search(line)
            current['smem_bytes'] = int(smem.group(1)) if smem else 0
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--source', default='flash_backward',
                    choices=sorted(SOURCES))
    ap.add_argument('--match', default='',
                    help='regular expression on the demangled name')
    ap.add_argument('--raw', default='',
                    help='also write ptxas\'s whole report to this file')
    ap.add_argument('--sass', default='',
                    help='count the SASS instructions matching this regular '
                    'expression in each shown kernel, by opcode')
    args = ap.parse_args(argv)
    source, parts = SOURCES[args.source]
    report, counts = compile_verbose(source, parts, args.sass)
    if args.raw:
        with open(args.raw, 'w') as f:
            f.write(report)
    kernels = parse(report)
    names = demangle(kernels)
    shown = spilled = serialised = 0
    for mangled, info in sorted(kernels.items(), key=lambda kv: names[kv[0]]):
        if not re.search(args.match, names[mangled]):
            continue
        shown += 1
        spilled += bool(info.get('spill_stores') or info.get('spill_loads'))
        serialised += any(w.startswith('(C751') for w in info['warnings'])
        extra = {'sass': counts.get(mangled, {})} if args.sass else {}
        print(json.dumps(dict(kernel=names[mangled], **info, **extra)))
    print(json.dumps(dict(source=source.name, parts=parts,
                          kernels=len(kernels), shown=shown, spilled=spilled,
                          serialised=serialised)))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
