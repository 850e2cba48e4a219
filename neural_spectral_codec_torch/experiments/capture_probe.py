"""Which of the verifier's linear-algebra calls a CUDA graph can capture.

    python -m neural_spectral_codec_torch.experiments.capture_probe [--json out.json]

The torch verifier's steps are captured into CUDA graphs
(``retrieval/verification.RegistrationExecutable`` and
``PrepareExecutable``) only where every call in them runs without a host
sync. For each linear-algebra call the steps make or once made, at the
verifier's shapes, this runs it once on a side stream and then tries to
capture it (``thread_local``) and replay it: ``solve_ex`` (6 × 6, the
Gauss-Newton update), ``inv_ex`` (4,096 3 × 3 matrices, GICP), and
``det`` and ``svd`` (3 × 3, point-to-point's Kabsch solve) and ``eigh``
(4,096 3 × 3, ``prepare``), which no card path calls any more: kernels R
and C (``retrieval/pca_kernel.py``) do that work. A refused capture can
leave the CUDA context unusable, so every call is probed in a fresh
interpreter.
Prints one JSON object: for each call "captured" (and whether the replay
equals the eager result) or the first line of the error. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CALLS = ("solve_ex", "inv_ex", "det", "svd", "eigh")
_MODULE = "neural_spectral_codec_torch.experiments.capture_probe"
_ROOT = Path(__file__).resolve().parents[2]


def probe(name: str) -> dict:
    """Capture and replay ``name`` in this process."""
    import torch
    from neural_spectral_codec_torch.device import resolve_device
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    a6 = (torch.eye(6, device=dev) * 3
          + torch.rand(6, 6, generator=g, device=dev))
    b6 = torch.rand(6, generator=g, device=dev)
    m = (torch.eye(3, device=dev).repeat(4096, 1, 1) * 2
         + 0.1 * torch.rand(4096, 3, 3, generator=g, device=dev))
    sym = m @ m.transpose(1, 2)
    h = torch.rand(3, 3, generator=g, device=dev)
    fn = {"solve_ex": lambda: torch.linalg.solve_ex(
              a6, b6, check_errors=False)[0],
          "inv_ex": lambda: torch.linalg.inv_ex(m, check_errors=False)[0],
          "det": lambda: torch.linalg.det(h),
          "svd": lambda: torch.linalg.svd(h)[0],
          "eigh": lambda: torch.linalg.eigh(sym)[1]}[name]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        want = fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            got = fn()
        graph.replay()
        torch.cuda.synchronize(dev)
    except RuntimeError as err:      # torch.AcceleratorError included
        return {"captured": False, "error": str(err).splitlines()[0][:300]}
    return {"captured": True, "replay_equals_eager": bool(
        torch.equal(got, want))}


def run() -> dict:
    """Each call probed in its own interpreter; {name: result}."""
    out = {}
    for name in CALLS:
        proc = subprocess.run([sys.executable, "-m", _MODULE, "--one", name],
                              cwd=_ROOT, capture_output=True, text=True,
                              timeout=300)
        # the JSON line is printed before a context left broken by a
        # refused capture may fail the interpreter's exit
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            raise RuntimeError(f"capture_probe {name}: exit "
                               f"{proc.returncode}\n{proc.stderr[-2000:]}")
        out[name] = json.loads(lines[-1])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", choices=CALLS, help=argparse.SUPPRESS)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(probe(args.one)), flush=True)
        return {}
    out = run()
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
