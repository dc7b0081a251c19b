"""Time the tensor-core flash kernel with one part of its work cut out.

    python -m repro_torch.kernels.flash_attention.cutouts

Builds ``csrc/flash_attention.cu`` as it is and with one part of the
tensor-core route's per-tile work removed by a textual cut, each into
``build/repro_torch/cutouts/<cut>/``, then times one launch of each build
(CUDA events, median of 10 after 2 warm-ups, the builds in turns and
then in reverse order) at chip_smoke.py's LM prefill shapes (B 8,
S 4096, Hq 32, bf16, causal).  The cuts:

* ``no_exp``: p = s scale log2(e) - max, no exponential;
* ``no_softmax``: the whole online softmax (masks, max, exponentials,
  sums, the rescale factor) skipped;
* ``no_pv``: the P.V products not issued;
* ``no_qk``: the Q.K^T products not issued;
* ``item_a_block``: not a cut of work but of persistence: one block a
  work item, so no item's loads overlap another's compute (this build
  alone computes right results).

A cut build computes wrong results; it is timed only.  What a cut saves
is the time that part adds beside the rest.  Prints the card's name and
power limit, then one JSON line per shape.  Needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import struct
import subprocess

import torch

from repro_torch.kernels import _build

__all__ = ["CUTS", "main"]

_SRC = "flash_attention.cu"
#: each cut: (text in the source, its replacement), every one must match
CUTS = {
    "full": [],
    "no_exp": [("sc[i] = ex2(fmaf(sc[i], a.scale_log2, -mc[r]));",
                "sc[i] = fmaf(sc[i], a.scale_log2, -mc[r]);")],
    "no_softmax": [("                                           "
                    "const TcArgs& a) {\n  if (edge) {",
                    "                                           "
                    "const TcArgs& a) {\n  alpha[0] = alpha[1] = 1.f;\n"
                    "  return;\n  if (edge) {")],
    "no_pv": [("    if constexpr (HD == 64)\n"
               "      wgmma_m64n64k16_rs(acc, pb + 4 * kk, d);\n"
               "    else\n"
               "      wgmma_m64n128k16_rs(acc, pb + 4 * kk, d);",
               "    (void)d;")],
    "no_qk": [("    wgmma_m64n128k16_ss(\n",
               "    if (false) wgmma_m64n128k16_ss(\n")],
    "item_a_block": [("kernel<<<(unsigned)(items < sms ? items : sms),",
                      "kernel<<<(unsigned)items,")],
}
#: (name, B, S, Hq, Hkv, hd) as chip_smoke.LM_FLASH_SHAPES
SHAPES = (("tinyllama-1.1b prefill", 8, 4096, 32, 4, 64),
          ("qwen3-4b prefill", 8, 4096, 32, 8, 128))


def _build_cuts() -> dict:
    """Each cut's library, compiled in parallel; raises if a cut does not
    apply or a build fails."""
    root = _build.BUILD_DIR / "cutouts"
    procs = {}
    for name, edits in CUTS.items():
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        for path in _build._sources("flash_attention"):
            shutil.copy(path, out / path.name)
        text = (out / _SRC).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name}: {old!r} is not in {_SRC} "
                                   "exactly once")
            text = text.replace(old, new)
        (out / _SRC).write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / "lib.so"), str(out / _SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out / "lib.so")
    logs = {name: proc.communicate()[0] for name, (proc, _) in procs.items()}
    libs = {}
    symbol, argtypes = _build.KERNELS["flash_attention"]
    for name, (proc, lib) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name}:\n{logs[name]}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def _caller(fn, q, k, v):
    """One launch of ``fn`` on the model layout, as kernel._launch makes
    it; raises unless it took the tensor-core route."""
    b, s, hq, hd = q.shape
    out = torch.empty_like(q)
    strides = struct.pack("12q", *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], s * hq * hd, hq * hd, hd)
    route = ctypes.c_int(-1)
    stream = _build.stream(q.device)

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, s, hq, hq // k.shape[2], hd, 1, 1, 0,
                 hd ** -0.5, ctypes.byref(route), stream)
        _build.check(err, "flash_attention")
        if route.value != 3:
            raise RuntimeError(f"route {route.value}, not general_tc")
    return call


def _ms(call, reps: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cutouts: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _build_cuts()
    dev = torch.device("cuda")
    for name, b, s, hq, hkv, hd in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(hd)
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        calls = {cut: _caller(fn, q, k, v) for cut, fn in libs.items()}
        ms = {cut: [] for cut in calls}
        for cut in list(calls) + list(calls)[::-1]:
            ms[cut].append(_ms(calls[cut]))
        print(json.dumps({"shape": name, "ms": ms, "saved_ms": {
            cut: statistics.mean(ms["full"]) - statistics.mean(t)
            for cut, t in ms.items() if cut != "full"}}), flush=True)
        del q, k, v, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
