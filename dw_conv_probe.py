#!/usr/bin/env python3
"""Time builds of the integer depthwise kernel (csrc/dw_conv_int8.cu, or
another version of it) at the depthwise shapes MNASNet and MobileNetV2
serve on it (batch 256, 224x224), in the path's mode (S = 1, a relu
requant onto a 4-bit site, the shape's pad offset), beside cuDNN's bf16
depthwise conv on the same codes and the bytes bound (each code read and
written once). Every build is held bit-exact to the plain version.

    python3 dw_conv_probe.py [--source NAME=FILE ...] [--split] [--sweep]

- ``--source NAME=FILE`` adds a version of the kernel's source (the
  repo's is always built, as ``repo``). The first version, for instance:
  ``git show 76176f3:shiftedscalequantization_tpu_torch/csrc/dw_conv_int8.cu
  > archive_check/dw_first.cu`` (``archive_check/`` is git-ignored).
- ``--split``: beside each version, builds that leave out parts of it, to
  split its time: ``nostore`` (no requant and no stores: the sums reduced
  to a rarely taken store), and for the first version ``noarith`` (each
  sum one staged code) and ``stage`` (both). Staging is ``stage``'s time,
  the arithmetic ``nostore`` less ``stage``, the epilogue the whole less
  ``nostore``.
- ``--sweep``: the repo version at the other tiles (slab, column tile,
  band) around its own choice.

Builds with nvcc into build/dw_conv_probe/ (a plain C library per
version, loaded with ctypes); prints one JSON line a shape and the sums
over MNASNet's 11 launches, with the card's name and power limit, and
writes them to chiprun_out/dw_conv_probe.json. Runs on the card only.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "shiftedscalequantization_tpu_torch", "csrc")
BUILD = os.path.join(ROOT, "build", "dw_conv_probe")
BATCH = 256
HBM_BYTES_PER_S = 3.35e12
# (H, W, C, K, stride, pad offset, MNASNet launches); the last is
# MobileNetV2's features.1.conv.0
SHAPES = [(112, 112, 64, 3, 1, 128, 1), (56, 56, 144, 5, 2, 0, 1),
          (28, 28, 240, 5, 1, 0, 2), (28, 28, 480, 5, 2, 0, 1),
          (14, 14, 960, 5, 1, 0, 2), (14, 14, 1152, 5, 2, 0, 1),
          (7, 7, 2304, 5, 1, 0, 3), (112, 112, 32, 3, 1, 128, 0)]

# The sums reduced to one rarely taken store: the first version after its
# arithmetic, the repo's in its per-row epilogue.
FIRST_NOSTORE = ("#pragma unroll\n  for (int i = 0; i < K; ++i) {", """  {
    int h = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int t = 0; t < TW; ++t) h ^= acc[s][t] * (t + 1);
    if (h == 0x7fffabcd) reinterpret_cast<int8_t*>(a.out)[tid] = (int8_t)h;
    return;
  }
""")
REPO_NOSTORE = ("    const size_t oo = o_col + (size_t)o * out_row;",
                "  };\n\n  // The band's input rows in order.",
                """    int h = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) h ^= __float_as_int(v[j]) * (j + 1);
    if (h == 0x7fffabcd) reinterpret_cast<int*>(a.out)[o] = h;
""")
FORCE = """
namespace {
int probe_tile[3] = {0, 0, 0};
}
extern "C" void probe_force(int cs, int cb, int rb) {
  probe_tile[0] = cs, probe_tile[1] = cb, probe_tile[2] = rb;
}
extern "C" void probe_tile_of(int Ho, int Wo, int C, int K, int ST, int S,
                              int unit, int* o) {
  const Tile t = choose_tile(Ho, Wo, C, K, ST, S, unit);
  o[0] = t.cs, o[1] = t.cb, o[2] = t.rb;
}
"""


def first_variant(src, v):
    """The first version (one channel a lane, fixed 8 x 16 tiles) without
    its stores ('nostore'), its arithmetic ('noarith') or both
    ('stage')."""
    tail = ("        for (int j = 0; j < K; ++j) acc[s][t] += "
            "xr[t * ST + j] * wr[j];\n    }\n  }\n")
    if v in ("noarith", "stage"):
        i = src.index(FIRST_NOSTORE[0])
        j = src.index(tail) + len(tail)
        src = src[:i] + """#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < TW; ++t)
      acc[s][t] = xs[((row * ST) * IC + t * ST) * CT + lane]
                  + ws[s * KK * CT + lane];
""" + src[j:]
        tail = "+ ws[s * KK * CT + lane];\n"
    if v in ("nostore", "stage"):
        j = src.index(tail) + len(tail)
        src = src[:j] + FIRST_NOSTORE[1] + src[j:]
    return src


def repo_variant(src, v):
    """The repo version without its requant and stores ('nostore'), or
    with an entry that forces its tile ('force')."""
    if v == "nostore":
        i, j = src.index(REPO_NOSTORE[0]), src.index(REPO_NOSTORE[1])
        return src[:i] + REPO_NOSTORE[2] + src[j:]
    old = "const Tile t = choose_tile("
    src = src.replace(old, "const Tile t = probe_tile[0] ? make_tile("
                      "probe_tile[0], probe_tile[1], probe_tile[2], K, "
                      "stride, S) : choose_tile(")
    src = src.replace('#include "requant.cuh"', '#include "requant.cuh"\n'
                      'namespace { extern int probe_tile[3]; }', 1)
    return src + FORCE


def build(sources):
    """{name: ctypes library} of {name: source text}, one nvcc each, all
    started together."""
    sys.path.insert(0, ROOT)
    from shiftedscalequantization_tpu_torch.ops.cuda import _build
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, lib = (os.path.join(BUILD, f"{name}{ext}")
                   for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.GENCODE, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", CSRC,
               "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{err}")
        regs = sorted({int(w) for line in err.splitlines()
                       if "registers" in line
                       for w in [line.split("Used ")[1].split()[0]]})
        spills = sorted({line.strip() for line in err.splitlines()
                         if "spill" in line and " 0 bytes spill" not in line})
        print(f"  {name}: {regs[0]}-{regs[-1]} registers"
              + (f", spills {spills}" if spills else ", no spills"),
              flush=True)
        fn = ctypes.CDLL(lib)
        fn.ssq_dw_conv_int8.argtypes = _build.SIGNATURES["ssq_dw_conv_int8"]
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=FILE")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("dw_conv_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from shiftedscalequantization_tpu_torch.ops.cuda import dw_conv
    from shiftedscalequantization_tpu_torch.ops.cuda.int_matmul import (
        conv_launch_outputs)
    from shiftedscalequantization_tpu_torch.ops.cuda.requant import Requant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    repo = open(os.path.join(CSRC, "dw_conv_int8.cu")).read()
    sources = {"repo": repo_variant(repo, "force")}
    if args.split:
        sources["repo_nostore"] = repo_variant(repo, "nostore")
    for spec in args.source:
        name, path = spec.split("=", 1)
        text = open(path).read()
        sources[name] = text
        if args.split:
            for v in ("nostore", "noarith", "stage"):
                sources[f"{name}_{v}"] = first_variant(text, v)
    libs = build(sources)
    force = libs["repo"].probe_force
    force.argtypes = [ctypes.c_int] * 3
    tile_of = libs["repo"].probe_tile_of
    tile_of.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]

    def launch(lib, x, wm, k, st, pad, off, rq):
        b, h, w, c = x.shape
        out, table, dl, rqa, keep = conv_launch_outputs(  # noqa: F841
            x, wm, (h - 1) // st + 1, (w - 1) // st + 1, pad, None, None,
            off, rq)
        err = lib.ssq_dw_conv_int8(
            x.data_ptr(), wm.data_ptr(), None,
            None if off is None else off.data_ptr(), None, out.data_ptr(),
            1, b, h, w, c, k, st, pad, ctypes.addressof(rqa),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for h, w, c, k, st, offset, count in SHAPES:
        ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
        lo = -128 if offset else -8
        x = torch.randint(lo, -lo, (BATCH, h, w, c), generator=gen,
                          device="cuda", dtype=torch.int8)
        wm = torch.randint(-2, 3, (1, c, k * k), generator=gen, device="cuda",
                           dtype=torch.int8)
        off = offset * wm.sum(dim=2, dtype=torch.int32) if offset else None
        col = torch.rand((2, c), generator=gen, device="cuda")
        t = lambda v: torch.tensor(v, device="cuda")  # noqa: E731
        rq = Requant(m1=(col[0] * 1.5 + 0.5) * 15 / ((209.0 if offset
                                                      else 6.6) * k),
                     c1=col[1] * 8 + 0.5, q1=(t(0.0), t(15.0), t(0.0)))
        want = dw_conv.dw_conv_int8_plain(x, wm, (k, k), (st, st),
                                          (k // 2, k // 2), -offset,
                                          acc_offset=off, requant=rq)
        tile = (ctypes.c_int * 3)()
        tile_of(ho, wo, c, k, st, 1, 16, ctypes.addressof(tile))
        row = dict(shape=[h, w, c, k, st, offset], mnasnet_launches=count,
                   tile=list(tile))
        fns = {name: (lambda lib=lib: launch(lib, x, wm, k, st, -offset,
                                             off, rq))
               for name, lib in libs.items()}
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wm[0].reshape(c, 1, k, k).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        fns["cudnn"] = lambda: F.conv2d(xb, wb, None, st, k // 2, 1, c)
        for name in fns:
            if name in libs and "_" not in name:
                got = fns[name]()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} at {row['shape']}: "
                                         "differs from the plain version")
        # two turns, forward then back; the faster of each
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(chip_smoke.time_graph(fns[name],
                                                         iters=30))
        row.update({f"{name}_ms": min(v) for name, v in times.items()})
        n_bytes = BATCH * (h * w + ho * wo) * c + k * k * c + 16 * c
        row["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        if args.sweep:
            sweep = []
            for cs in (16, 32, 48, 64, 80, 96, 128, 144):
                if cs > c:
                    continue
                g = cs // 4
                for cb in sorted({min(128 // g, wo), max(1, min(
                        128 // g, wo) // 2)}):
                    cb = -(-wo // -(-wo // cb))
                    for rmax in (32, 14, 7):
                        rb = -(-ho // -(-ho // min(ho, rmax)))
                        smem = k * 2 * cs * 4 + ((rb - 1) * st + k) * (
                            (cb - 1) * st + k) * cs
                        if smem > 48 * 1024 or g * cb < 32:
                            continue
                        force(cs, cb, rb)
                        got = fns["repo"]()
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(f"tile {cs, cb, rb}")
                        sweep.append((chip_smoke.time_graph(fns["repo"],
                                                            iters=30),
                                      [cs, cb, rb]))
            force(0, 0, 0)
            row["sweep"] = sorted(sweep)[:6]
        print(json.dumps(row), flush=True)
        rows.append(row)
    mnasnet = {key: sum(r[key] * r["mnasnet_launches"] for r in rows)
               for key in rows[0] if key.endswith("_ms")}
    print("MNASNet's 11 launches:", json.dumps(mnasnet), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dw_conv_probe.json"),
              "w") as f:
        json.dump(dict(device=smi, argv=sys.argv[1:], rows=rows,
                       mnasnet=mnasnet), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
