"""Benchmark entry point of the port (the root ``run_benchmark.py`` of the
JAX package, with ``--device`` in place of ``--platform``):

    python -m neural_spectral_codec_torch.benchmark_cli \\
        --config configs/inference.yaml [--checkpoint ckpt/final_model.pt] \\
        [--output results.json] [--synthetic N] [--device cuda|cpu]

Reads the config's test (else val) sequences, runs
``evaluation.run_benchmark`` on them and writes the results JSON
(``--output``, else ``benchmark.results_path``, else
``<system.output_dir>/benchmark_results.json``; none when
``benchmark.save_results`` is false and no ``--output`` is given). The
checkpoint is a ``.pt`` file of the port's trainer.

The package's top-level name ``run_benchmark`` is the function
``evaluation.run_benchmark``, as in the JAX package; this module is the
command line around it.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Place-recognition benchmark (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="GNN weights, a .pt file of the port's trainer")
    p.add_argument("--output", default=None, help="results JSON path")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="benchmark on N synthetic frames instead of datasets")
    p.add_argument("--device", default="cuda",
                   help="'cuda[:N]' (default) or 'cpu'; no fallback")
    args = p.parse_args(argv)

    from neural_spectral_codec_torch.evaluation import run_benchmark
    from neural_spectral_codec_torch.pipeline import _loaders_from_config
    from neural_spectral_codec_torch.utils.config import load_config
    from neural_spectral_codec_torch.utils.logging_setup import setup_logging

    setup_logging(None)
    config = load_config(args.config)
    if args.synthetic:
        from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
        loaders = [SyntheticLoader(n_frames=args.synthetic, seed=0,
                                   loops=2.0)]
    else:
        loaders = (_loaders_from_config(config, "test")
                   or _loaders_from_config(config, "val"))
    bench = config.get("benchmark", {})
    out_dir = config.get("system", {}).get("output_dir", "outputs")
    out = args.output or bench.get(
        "results_path", f"{out_dir}/benchmark_results.json")
    if not bench.get("save_results", True) and not args.output:
        out = None
    results = run_benchmark(loaders, config, checkpoint_path=args.checkpoint,
                            results_path=out, device=args.device)
    print(json.dumps(results.get("mean", results), indent=2))
    return results


if __name__ == "__main__":
    main()
