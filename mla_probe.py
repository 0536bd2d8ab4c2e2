#!/usr/bin/env python3
"""Where a CTA of the MLA decode's split kernel spends its clocks, on the card.

Run from the repository root on a machine with an H100 and nvcc:

    python3 mla_probe.py

It copies this checkout's ``src`` into ``build/mla_probe`` (git-ignored),
adds ``clock64()`` probes around the phases of ``mla_decode_kernel`` in the
copy's ``csrc/paged_attention.cu`` -- staging the query (from the CTA's
start to its query fragments), waiting for each tile, the scores, the
softmax, P @ V (each to the barrier that ends it) -- builds the copy, runs
the decode twice at ``chip_smoke.py``'s phase-7 shape in fp32 and in bf16,
and prints, for thread 0 of a few CTAs of the 1901-key slot (head chunk 0,
splits 0, 3, 7 and 14 where they exist), one JSON line of SM clocks per
phase summed over the CTA's tiles.  The probes add clocks of their own:
compare the phases with each other, not with the kernel's device time.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "mla_probe"
PRINT = ('  if (tid == 0 && blockIdx.x == 0 && b == 3 && (z == 0 || z == 3 || z == 7 || '
         'z == 14))\n    printf("{\\"probe\\": \\"mla_decode_kernel\\", \\"pool_bytes\\": %d, '
         '\\"split\\": %d, \\"tiles\\": %d, \\"query\\": %lld, \\"wait\\": %lld, '
         '\\"scores\\": %lld, \\"softmax\\": %lld, \\"pv\\": %lld, \\"total\\": %lld}\\n", '
         '(int)sizeof(T), z, tiles, t_query, t_wait, t_scores, t_softmax, t_pv, '
         'clock64() - t_start);\n')
# (anchor in mla_decode_kernel, text to add after it)
PROBES = [
    ("  const int tid = threadIdx.x;\n",
     "  long long t_start = clock64(), t_query = 0, t_wait = 0, t_scores = 0, t_softmax = 0,"
     " t_pv = 0, t_mark = 0;\n"),
    ("  __syncthreads();  // the last stage is the ring's again\n",
     "  t_query = clock64() - t_start;\n"),
    ("  for (int i = 0; i < tiles; ++i) {\n", "    t_mark = clock64();\n"),
    ("    mbar_wait(full_s + i % kS, (i / kS) & 1);  // tile i has landed\n",
     "    t_wait += clock64() - t_mark;\n    t_mark = clock64();\n"),
    ("      dst[8 * TK + 1] = sc[0][nn][3] + sc[1][nn][3];\n    }\n    __syncthreads();\n",
     "    t_scores += clock64() - t_mark;\n    t_mark = clock64();\n"),
    ("      if (sub == 0) alpha_s[hs] = alpha;\n    }\n    __syncthreads();\n",
     "    t_softmax += clock64() - t_mark;\n    t_mark = clock64();\n"),
    ("    __syncthreads();  // the stage, the partial scores and P are free\n",
     "    t_pv += clock64() - t_mark;\n"),
    ("  // the partial of each head for this split\n", PRINT),
]


def probed(source: str) -> str:
    """``paged_attention.cu`` with the probes in ``mla_decode_kernel``."""
    start = source.index("mla_decode_kernel(MlaArgs p) {")
    end = source.index("mla_decode_combine_kernel(MlaArgs p) {")
    body = source[start:end]
    for anchor, add in PROBES:
        if body.count(anchor) != 1:
            raise SystemExit(f"mla_probe.py: the kernel no longer has {anchor.strip()!r}")
        body = body.replace(anchor, anchor + add)
    source = source[:start] + body + source[end:]
    return source.replace("#include <cfloat>\n", "#include <cfloat>\n#include <cstdio>\n", 1)


def run() -> None:
    """In the probed copy: the decode, twice in each type, synchronised."""
    sys.path.insert(0, str(COPY / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels.paged_attention import mla_paged_attention_decode

    gen = torch.Generator(device="cpu").manual_seed(0)
    scale = chip_smoke.mla_table(torch)[2]
    for dtype in (torch.float32, torch.bfloat16):
        args = chip_smoke.mla_operands(torch, gen, dtype)
        for _ in range(2):
            mla_paged_attention_decode(*args, scale=scale)
            torch.cuda.synchronize()


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--run":
        run()
        return 0
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cu = COPY / "src" / "repro_torch" / "kernels" / "csrc" / "paged_attention.cu"
    cu.write_text(probed(cu.read_text()))
    done = subprocess.run([sys.executable, __file__, "--run"], capture_output=True, text=True,
                          timeout=900)
    print("\n".join(line for line in done.stdout.splitlines() if line.startswith('{"probe"')),
          flush=True)
    if done.returncode:
        print(done.stderr[-4000:], file=sys.stderr)
    return done.returncode


if __name__ == "__main__":
    sys.exit(main())
