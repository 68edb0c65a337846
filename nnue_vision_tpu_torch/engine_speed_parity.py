"""C++ engine speed parity: the repository's engine against the unmodified
upstream reference engine, on the port's models (the port's counterpart of
`scripts/engine_speed_parity.py`).

    python -m nnue_vision_tpu_torch.engine_speed_parity [--images 32] \\
        [--iters 50] [--ref-src <upstream checkout>/engine] [--out FILE] \\
        [--device cuda]

Builds both engines (the repository's with `training/engine_build.py` into
`build/torch_engine/`; the reference's with cmake and make into
`build/torch_engine_ref/`), compiles a minimal timing harness against each
engine's static library, writes the SAME flagship models (a ~1M-parameter
NNUE and an EtinyNet-micro, untrained, built by the port's facade on
`--device` and written with the port's `formats.py`), and times the full
image → logits evaluation loop of each on identical image bytes, on the
host. Prints a markdown table and with `--out` writes it.

The two harness sources are the JAX tool's, copied; nothing is copied
from the reference: its compiled library is linked as a baseline, as
tests/test_upstream_interchange.py uses its binaries. `--ref-src` is the
reference's `engine/` directory, by default the one in the upstream
checkout that `NV_REFERENCE_DIR` names; with neither given, or with no
engine sources there, the tool exits 2. Exits 2 too when ours is slower (< 0.95×) on
a model, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent
# the upstream checkout, where NV_REFERENCE_DIR names one; no default
REFERENCE = Path(os.environ["NV_REFERENCE_DIR"]) if os.environ.get(
    "NV_REFERENCE_DIR") else None
REF_BUILD = REPO / "build" / "torch_engine_ref"

OUR_HARNESS = r"""
// Timing harness for the in-repo engine (nv::). Loads a .nnue and a
// .etiny model, evaluates N images ITERS times each, prints ms/image.
#include <chrono>
#include <cstdio>
#include <fstream>
#include <vector>
#include "nv/model.h"

using Clock = std::chrono::steady_clock;

static std::vector<float> read_floats(const char* path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  size_t bytes = f.tellg();
  f.seekg(0);
  std::vector<float> v(bytes / sizeof(float));
  f.read(reinterpret_cast<char*>(v.data()), bytes);
  return v;
}

int main(int argc, char** argv) {
  // argv: nnue_path etiny_path images_path H W N ITERS
  const char* nnue_path = argv[1];
  const char* etiny_path = argv[2];
  auto images = read_floats(argv[3]);
  int h = std::atoi(argv[4]), w = std::atoi(argv[5]);
  int n = std::atoi(argv[6]), iters = std::atoi(argv[7]);
  size_t stride = size_t(h) * w * 3;

  nv::NnueNet nnue = nv::load_nnue_file(nnue_path);
  volatile float sink = 0.f;
  // warmup
  for (int i = 0; i < n; ++i)
    sink += nv::nnue_evaluate(nnue, &images[i * stride], h, w).logits[0];
  auto t0 = Clock::now();
  for (int it = 0; it < iters; ++it)
    for (int i = 0; i < n; ++i)
      sink += nv::nnue_evaluate(nnue, &images[i * stride], h, w).logits[0];
  double ms = std::chrono::duration<double, std::milli>(Clock::now() - t0)
                  .count() / (double(iters) * n);
  std::printf("NNUE_MS_PER_IMAGE:%.6f\n", ms);

  nv::EtinyNet et = nv::load_etiny_file(etiny_path);
  for (int i = 0; i < n; ++i)
    sink += nv::etiny_evaluate(et, &images[i * stride], h, w)[0];
  t0 = Clock::now();
  for (int it = 0; it < iters; ++it)
    for (int i = 0; i < n; ++i)
      sink += nv::etiny_evaluate(et, &images[i * stride], h, w)[0];
  ms = std::chrono::duration<double, std::milli>(Clock::now() - t0).count() /
       (double(iters) * n);
  std::printf("ETINY_MS_PER_IMAGE:%.6f\n", ms);
  return sink == 12345.f;  // defeat optimizer, always ~0
}
"""

REF_HARNESS = r"""
// Timing harness linked against the UNMODIFIED reference engine library.
#include <chrono>
#include <cstdio>
#include <fstream>
#include <vector>
#include "nnue_engine.h"

using Clock = std::chrono::steady_clock;

static std::vector<float> read_floats(const char* path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  size_t bytes = f.tellg();
  f.seekg(0);
  std::vector<float> v(bytes / sizeof(float));
  f.read(reinterpret_cast<char*>(v.data()), bytes);
  return v;
}

int main(int argc, char** argv) {
  const char* nnue_path = argv[1];
  const char* etiny_path = argv[2];
  auto images = read_floats(argv[3]);
  int h = std::atoi(argv[4]), w = std::atoi(argv[5]);
  int n = std::atoi(argv[6]), iters = std::atoi(argv[7]);
  size_t stride = size_t(h) * w * 3;

  nnue::NNUEEvaluator ev;
  if (!ev.load_model(nnue_path)) { std::fprintf(stderr, "nnue load failed\n"); return 1; }
  volatile float sink = 0.f;
  for (int i = 0; i < n; ++i)
    sink += ev.evaluate_logits(&images[i * stride], h, w, 0)[0];
  auto t0 = Clock::now();
  for (int it = 0; it < iters; ++it)
    for (int i = 0; i < n; ++i)
      sink += ev.evaluate_logits(&images[i * stride], h, w, 0)[0];
  double ms = std::chrono::duration<double, std::milli>(Clock::now() - t0)
                  .count() / (double(iters) * n);
  std::printf("NNUE_MS_PER_IMAGE:%.6f\n", ms);

  nnue::EtinyNetEvaluator eev;
  if (!eev.load_model(etiny_path)) { std::fprintf(stderr, "etiny load failed\n"); return 1; }
  std::vector<float> out(eev.get_num_classes());
  for (int i = 0; i < n; ++i) {
    eev.evaluate(&images[i * stride], out.data(), h, w);
    sink += out[0];
  }
  t0 = Clock::now();
  for (int it = 0; it < iters; ++it)
    for (int i = 0; i < n; ++i) {
      eev.evaluate(&images[i * stride], out.data(), h, w);
      sink += out[0];
    }
  ms = std::chrono::duration<double, std::milli>(Clock::now() - t0).count() /
       (double(iters) * n);
  std::printf("ETINY_MS_PER_IMAGE:%.6f\n", ms);
  return sink == 12345.f;
}
"""


def sh(cmd, **kw):
    return subprocess.run(cmd, check=True, capture_output=True, text=True, **kw)


def build_our_engine() -> Path:
    """The repository's engine (tools and `libnv_engine.a`), up to date."""
    from nnue_vision_tpu_torch.training.engine_build import compile_cpp_engine

    return compile_cpp_engine("nnue").parent


def build_ref_engine(ref_src: Path) -> Path:
    """The reference engine's static library, built once into REF_BUILD."""
    lib = REF_BUILD / "libnnue_engine.a"
    if not lib.exists():
        REF_BUILD.mkdir(parents=True, exist_ok=True)
        sh(["cmake", "-S", str(ref_src), "-B", str(REF_BUILD),
            "-DCMAKE_BUILD_TYPE=Release"])
        sh(["make", "-C", str(REF_BUILD), "nnue_engine", "-j4"])
    return REF_BUILD


def compile_harness(src: str, name: str, include: Path, lib: Path,
                    workdir: Path) -> Path:
    cpp = workdir / f"{name}.cpp"
    cpp.write_text(src)
    exe = workdir / name
    sh(["g++", "-O3", "-march=native", "-std=c++17", str(cpp),
        "-I", str(include), str(lib), "-lpthread", "-o", str(exe)])
    return exe


def parse_ms(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        if ":" in line and line.endswith(tuple("0123456789")):
            key, val = line.rsplit(":", 1)
            out[key] = float(val)
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ref-src", type=Path, default=None,
                    help="the reference's engine/ directory (default: "
                         "$NV_REFERENCE_DIR/engine)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the models are built (default: the card)")
    args = ap.parse_args(argv)

    if args.ref_src is None and REFERENCE is not None:
        args.ref_src = REFERENCE / "engine"
    if args.ref_src is None:
        print("no reference engine sources given: pass --ref-src <upstream "
              "checkout>/engine (or set NV_REFERENCE_DIR to the checkout)",
              file=sys.stderr)
        return 2
    if not (args.ref_src / "include").is_dir():
        print(f"reference engine sources not found at {args.ref_src}: pass "
              "--ref-src <upstream checkout>/engine (or set NV_REFERENCE_DIR "
              "to the checkout)", file=sys.stderr)
        return 2

    from nnue_vision_tpu_torch.compare_engine_speed import make_models, write_models

    nnue, etiny = make_models(args.device)
    our_build = build_our_engine()
    ref_build = build_ref_engine(args.ref_src)

    work = Path(tempfile.mkdtemp(prefix="speed_parity_"))
    ours = compile_harness(
        OUR_HARNESS, "ours", REPO / "engine" / "include",
        our_build / "libnv_engine.a", work)
    ref = compile_harness(
        REF_HARNESS, "ref", args.ref_src / "include",
        ref_build / "libnnue_engine.a", work)
    nnue_path, etiny_path = write_models(nnue, etiny, work)

    h = w = 32
    rng = np.random.default_rng(0)
    images = rng.random((args.images, h, w, 3), dtype=np.float32)
    img_path = work / "imgs.bin"
    images.tofile(img_path)

    argv = [str(nnue_path), str(etiny_path), str(img_path),
            str(h), str(w), str(args.images), str(args.iters)]
    t0 = time.perf_counter()
    ours_ms = parse_ms(sh([str(ours)] + argv).stdout)
    ref_ms = parse_ms(sh([str(ref)] + argv).stdout)
    elapsed = time.perf_counter() - t0

    rows = []
    for key, label in (("NNUE_MS_PER_IMAGE", "NNUE (10×10×8, L1=1024)"),
                       ("ETINY_MS_PER_IMAGE", "EtinyNet micro")):
        o, r = ours_ms[key], ref_ms[key]
        rows.append((label, o, r, r / o))

    lines = [
        "# C++ engine speed parity (measured, this host)",
        "",
        f"Same serialized models, same {args.images} random 32×32 images, "
        f"{args.iters} timed passes each, single core, both engines built "
        "-O3 -march=native. `speedup` > 1 means ours is faster. Method: "
        "`python -m nnue_vision_tpu_torch.engine_speed_parity` (harnesses "
        "link each engine's static library; full image→logits evaluation "
        "per call).",
        "",
        "| Model | ours ms/image | reference ms/image | speedup |",
        "|---|---|---|---|",
    ]
    for label, o, r, s in rows:
        lines.append(f"| {label} | {o:.4f} | {r:.4f} | {s:.2f}× |")
    report = "\n".join(lines) + "\n"
    print(report)
    print(f"(measurement took {elapsed:.1f}s)")

    if args.out:
        args.out.write_text(report)
        print(f"written to {args.out}")

    slower = [label for label, o, r, s in rows if s < 0.95]
    if slower:
        print(f"WARNING: ours slower on: {', '.join(slower)}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
