"""Registers of K4's bf16 kernel as ptxas allocates them, for the kernel
as built and for three variants of its source, on a machine with nvcc.

    python3 mxnet_tpu_torch/tools/k4_register_variants.py

Each variant is ``csrc/flash_attention.cu`` with one edit:

- ``as built``: the source unchanged;
- ``trap in the barrier wait``: a bounded spin that calls ``__trap()`` in
  ``mbar_wait`` (a watchdog against a hung pipeline);
- ``no setmaxnreg``: both ``setmaxnreg`` instructions removed;
- ``288 threads``: one producer warp instead of a producer warpgroup,
  ``__launch_bounds__(288, 1)``, no ``setmaxnreg``.

For the head-dim tiles 128 and 64 it prints the registers a thread at
entry (ptxas), the registers the SASS addresses (``cuobjdump``), spill
bytes, and whether ptxas serialised the wgmmas (warning C7512). All
variants compile in parallel into a temporary directory; nothing runs on
the card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "csrc" / "flash_attention.cu"
CUDA = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _edit(text, old, new):
    if old not in text:
        raise SystemExit("the source no longer has %r" % old)
    return text.replace(old, new)


def variants(text):
    wait = "  while (!done)\n    asm volatile("
    trap = _edit(text, wait, "  unsigned spins = 0;\n  while (!done) {\n"
                 "    if (++spins > (1u << 30)) __trap();\n    asm volatile(")
    trap = _edit(trap, '        : "memory");\n}\n\n// one box',
                 '        : "memory");\n  }\n}\n\n// one box')
    plain = text
    for line in ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n',
                 '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n'):
        plain = _edit(plain, line, "")
    warp = _edit(plain, "constexpr int kThreads = 384;",
                 "constexpr int kThreads = 288;")
    return {"as built": text, "trap in the barrier wait": trap,
            "no setmaxnreg": plain, "288 threads": warp}


def report(log, so):
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*flash_fwd_bf16ILi(\d+)E\S*)",
                      line)
        if not m:
            continue
        sym, d = m.group(1), int(m.group(2))
        text = " ".join(lines[i + 1:i + 3])
        spill = re.search(r"(\d+) bytes spill stores", text)
        sass = subprocess.run([str(CUDA / "bin" / "cuobjdump"), "-sass",
                               "-fun", sym, so], capture_output=True,
                              text=True, check=True).stdout
        out["D<=%d" % d] = {
            "registers_at_entry": int(
                re.search(r"Used (\d+) registers", text).group(1)),
            "registers_used": 1 + max(
                int(r) for r in re.findall(r"\bR(\d+)\b", sass)),
            "spill_stores": int(spill.group(1)),
            "wgmma_serialized": any("C7512" in x and sym in x
                                    for x in lines)}
    return out


def main():
    nvcc = str(CUDA / "bin" / "nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for n, (name, text) in enumerate(variants(SRC.read_text()).items()):
            cu, so = os.path.join(tmp, "v%d.cu" % n), os.path.join(
                tmp, "v%d.so" % n)
            Path(cu).write_text(text)
            procs[name] = (so, subprocess.Popen(
                [nvcc, *FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(log, file=sys.stderr)
                raise SystemExit("nvcc failed for %r" % name)
            print(json.dumps({"variant": name, **report(log, so)}),
                  flush=True)


if __name__ == "__main__":
    main()
