"""The port's entry points on dataset directories, on the CPU:
``python -m neural_spectral_codec_torch.pipeline --mode train|online``,
``python -m neural_spectral_codec_torch.benchmark_cli`` and
``train_multi_dataset`` without ``--synthetic``, each on a YAML config
whose ``data.datasets`` name KITTI-layout sequences written from a
synthetic two-lap stream (and an NCLT and a HeLiPR sequence for
training)."""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_torch_data_loaders import (  # noqa: E402
    NCLT_DATE, make_helipr, make_nclt)
from test_torch_native_io import _write_kitti_stream  # noqa: E402
from test_torch_online import small_config  # noqa: E402

from neural_spectral_codec_torch import (  # noqa: E402
    benchmark_cli, pipeline, train_multi_dataset)
from neural_spectral_codec_torch.data import KITTILoader  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Run inside ``tmp_path`` (the CLIs log to ./logs) and restore the
    root logger the CLIs reconfigure."""
    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield tmp_path
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def write_config(tmp: Path, n_frames: int = 60, **sections) -> Path:
    """A KITTI-layout dataset (train 00, val 01, test 02) and a YAML
    config over ``small_config`` that names it."""
    data = tmp / "kitti"
    for seq, n in (("00", n_frames), ("01", 40), ("02", n_frames)):
        if not (data / "sequences" / seq).exists():
            _write_kitti_stream(data, n, seq=seq)
    cfg = small_config(tmp)
    kitti = lambda seqs: [{"type": "kitti", "root": str(data),  # noqa: E731
                           "sequences": seqs}]
    cfg["data"]["datasets"] = {"train": kitti(["00"]), "val": kitti(["01"]),
                               "test": kitti(["02"])}
    cfg["training"]["n_epochs"] = 1
    cfg.setdefault("model", {})["checkpoint_path"] = None
    (tmp / "out").mkdir(exist_ok=True)   # the g2o export makes no dirs
    cfg["loop_closing"] = {"output_format": "g2o",
                           "output_path": str(tmp / "out" / "loops.g2o")}
    cfg["benchmark"] = {"results_path": str(tmp / "out" / "bench.json")}
    cfg["validation"]["skip_frames"] = 20
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_pipeline_main_train_writes_checkpoint(workdir):
    cfg = write_config(workdir)
    trainer = pipeline.main(["--config", str(cfg), "--mode", "train",
                             "--device", "cpu"])
    ckpt = workdir / "ckpt" / "final_model.pt"
    assert ckpt.exists() and len(trainer.train_losses) == 1
    state = torch.load(ckpt, weights_only=True)["model"]
    assert all(torch.equal(v, trainer.model.state_dict()[k])
               for k, v in state.items())
    assert list((workdir / "logs").glob("train_*.log"))


def test_pipeline_main_online_writes_g2o(workdir):
    cfg = write_config(workdir, n_frames=80)
    pipe = pipeline.main(["--config", str(cfg), "--mode", "online",
                          "--device", "cpu"])
    g2o = workdir / "out" / "loops.g2o"
    assert g2o.exists() and "EDGE_SE3:QUAT" in g2o.read_text()
    kfs = pipe.selector.keyframes
    assert len(kfs) > 10 and all(kf.descriptor is not None for kf in kfs)
    with pytest.raises(SystemExit):
        pipeline.main(["--config", str(cfg), "--mode", "serve"])


def test_run_benchmark_main_writes_results(workdir):
    cfg = write_config(workdir)
    out = workdir / "out" / "r.json"
    res = benchmark_cli.main(["--config", str(cfg), "--device", "cpu",
                              "--output", str(out)])
    saved = json.loads(out.read_text())
    assert saved["mean"] == res["mean"]
    assert set(res["mean"]) == {"recall@1", "recall@5", "recall@10",
                                "best_f1"}
    (seq,) = saved["sequences"]
    assert seq == "02" and saved["sequences"][seq]["n_queries"] > 0
    assert saved["sequences"][seq]["n_keyframes"] == len(
        pipeline.NeuralSpectralCodecPipeline(
            yaml.safe_load(cfg.read_text()), device="cpu")
        ._process_sequence(KITTILoader(str(workdir / "kitti"), "02")))


def test_train_multi_dataset_reads_datasets(workdir):
    """No ``--synthetic``: KITTI, NCLT and HeLiPR sequences of
    ``data.datasets.train`` are read, and the checkpoint is written."""
    make_nclt(workdir / "nclt", n=4)
    make_helipr(workdir / "helipr" / "s", n=4)
    cfg = write_config(workdir)
    conf = yaml.safe_load(cfg.read_text())
    conf["data"]["datasets"]["train"] += [
        {"type": "nclt", "root": str(workdir / "nclt"),
         "sequences": [NCLT_DATE]},
        {"type": "helipr", "root": str(workdir / "helipr"),
         "sequences": ["s"]}]
    cfg.write_text(yaml.safe_dump(conf))
    trainer = train_multi_dataset.main(
        ["--config", str(cfg), "--epochs", "1", "--device", "cpu",
         "--checkpoint-dir", str(workdir / "ck2")])
    assert (workdir / "ck2" / "final_model.pt").exists()
    counts = trainer.pipeline.encoder.path_counts
    assert counts["general"] > 0
    assert np.isfinite(trainer.train_losses).all()
    conf["data"]["datasets"]["train"] = []
    cfg.write_text(yaml.safe_dump(conf))
    with pytest.raises(SystemExit):
        train_multi_dataset.main(["--config", str(cfg), "--device", "cpu"])
