"""The port's data-parallel training and evaluation through its command
lines, on the CPU: ``python -m lvae_tpu_torch.main --num-data-shards 2``
starts two gloo ranks itself; each launch has its own timeout (at most
120 s). Two ranks against one (the same steps, dropout on: every draw is
keyed by the global row or element), a checkpoint written at two ranks
resumed at one and at two, ``--streaming``, SIGTERM to one rank, the
``--steps-per-call`` refusal under gloo, ``evaluate --num-data-shards 2``,
data-dependent init on every rank, and the evaluation's out-of-memory
message. Each run is fp32; two ranks differ from one by the order of the
sums (the BatchNorm statistics, the loss's means, the gradients), held
to 1e-4 absolute after a few Adamax steps (measured ~1e-6), the conv biases
that only a BatchNorm reads to Adamax's bound of 2 lr a step
(``tests/test_torch_train.py``)."""

import functools
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lvae_tpu_torch.parallel import multihost
from lvae_tpu_torch.train.checkpoint import CheckpointManager
from torch_parallel_ranks import bn_fed_keys, launch_cases

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 120
LR = 3e-4
TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior",
        "--freebits", "0.5", "--beta-anneal", "4", "--batch-size", "32",
        "--test-batch-size", "64", "--seed", "5", "--device", "cpu", "--lr", str(LR),
        "--log-interval", "1", "--test-interval", "1000", "--checkpoint-interval", "2"]


def _main(out, *flags):
    from lvae_tpu_torch.main import main

    return main(TINY + ["--output-dir", str(out), *flags])


def _model(run_dir, step=None) -> dict:
    return CheckpointManager(str(run_dir)).load(step)["model"]


@functools.lru_cache(maxsize=None)
def _bn_fed() -> frozenset:
    """The BatchNorm-fed conv biases (and running means) of TINY's model."""
    from lvae_tpu_torch.config import TrainConfig
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.train.trainer import make_model

    cfg = TrainConfig(zdims=(3, 3), blocks_per_layer=1, n_filters=8, skip=True, gated=True,
                      learn_top_prior=True)
    return frozenset(bn_fed_keys(make_model(cfg, load_test_set("synthetic"),
                                            torch.device("cpu"))))


def _assert_close_runs(got: dict, want: dict, steps: int) -> None:
    roundoff_led = _bn_fed()
    for k, v in want.items():
        atol = 2 * LR * steps if k in roundoff_led else 1e-4
        np.testing.assert_allclose(got[k].double().numpy(), v.double().numpy(), rtol=0,
                                   atol=atol, err_msg=k)



@pytest.fixture(scope="module", autouse=True)
def _one_thread_ranks():
    """The ranks this file starts run on one thread each: the tier runs
    several test processes on the same cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-rank reference: 4 steps, checkpoints at 2 and 4."""
    out = tmp_path_factory.mktemp("one")
    _main(out, "--run-name", "r", "--max-steps", "4")
    return out / "r"


class TestTrainTwoRanks:
    def test_two_ranks_match_one_rank(self, one_rank, tmp_path, capfd):
        """Four steps at two ranks (dropout 0.2, --fused auto: the global
        BatchNorm and the dropout mask of the global elements) against one
        rank's, at both checkpoints; only rank 0 writes and logs."""
        assert _main(tmp_path, "--run-name", "r", "--max-steps", "4",
                     "--num-data-shards", "2") is None
        text = capfd.readouterr().out
        assert "x 2 ranks (gloo)" in text
        assert len(re.findall(r"\[train\] step +4 ", text)) == 1     # rank 0 alone logs
        for step in (2, 4):
            _assert_close_runs(_model(tmp_path / "r", step), _model(one_rank, step), step)
        assert sorted(os.listdir(tmp_path / "r")) == sorted(os.listdir(one_rank))

    def test_checkpoint_resumes_at_one_and_two_ranks(self, one_rank, tmp_path):
        """A checkpoint written at two ranks (step 2) resumed at one rank
        and at two, each to step 4, against the uninterrupted one-rank run."""
        _main(tmp_path / "a", "--run-name", "r", "--max-steps", "2", "--num-data-shards", "2")
        shutil.copytree(tmp_path / "a", tmp_path / "b")
        _main(tmp_path / "a", "--run-name", "r", "--max-steps", "4", "--auto-resume")
        _main(tmp_path / "b", "--run-name", "r", "--max-steps", "4", "--auto-resume",
              "--num-data-shards", "2")
        for d in ("a", "b"):
            _assert_close_runs(_model(tmp_path / d / "r", 4), _model(one_rank, 4), 4)

    def test_streaming_two_ranks(self, tmp_path):
        """--streaming at two ranks: each rank loads its rows of the global
        batches the one-rank loader draws, so the steps are one rank's."""
        _main(tmp_path / "one", "--run-name", "r", "--max-steps", "2", "--streaming")
        _main(tmp_path / "two", "--run-name", "r", "--max-steps", "2", "--streaming",
              "--num-data-shards", "2")
        _assert_close_runs(_model(tmp_path / "two" / "r", 2), _model(tmp_path / "one" / "r", 2),
                           2)

    def test_steps_per_call_refused_under_gloo(self, tmp_path, capfd):
        """--steps-per-call k > 1 needs the all-reduces in a CUDA graph,
        which gloo cannot hold: refused by name, not run eagerly."""
        with pytest.raises(SystemExit, match="--num-data-shards 2: a rank exited"):
            _main(tmp_path, "--max-steps", "2", "--num-data-shards", "2",
                  "--steps-per-call", "2", "--dry-run")
        assert "--steps-per-call 2: a CUDA graph" in capfd.readouterr().err

    def test_sigterm_to_one_rank_stops_both(self, tmp_path):
        """SIGTERM to rank 1 alone: both ranks stop at the same step, where
        rank 0 writes one final checkpoint, and both exit 0 (ranks that
        disagreed would wait on each other's collectives until the
        timeout)."""
        port = multihost.free_port()
        cmd = [sys.executable, "-m", "lvae_tpu_torch.main", *TINY, "--output-dir",
               str(tmp_path), "--run-name", "r", "--max-steps", "100000",
               "--checkpoint-interval", "100000", "--num-data-shards", "2"]
        procs = [subprocess.Popen(cmd, env=multihost.rank_env(r, 2, port), cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            lines = []
            deadline = time.time() + TIMEOUT_S
            for line in procs[0].stdout:        # rank 0 logs every step
                lines.append(line)
                if line.startswith("[train] step       3"):
                    procs[1].send_signal(signal.SIGTERM)
                    break
                assert time.time() < deadline, "".join(lines)
            out0 = "".join(lines) + procs[0].communicate(timeout=TIMEOUT_S)[0]
            out1 = procs[1].communicate(timeout=TIMEOUT_S)[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert [p.returncode for p in procs] == [0, 0], out0 + out1
        stop = int(re.search(r"interrupted: saving a final checkpoint at step (\d+)",
                             out0).group(1))
        assert 3 <= stop < 100000
        assert CheckpointManager(str(tmp_path / "r")).steps() == [stop]


class TestEvaluateTwoRanks:
    def test_matches_one_rank(self, one_rank, capfd):
        """evaluate --num-data-shards 2 (accepted, as lvae_tpu's evaluate.py
        accepts it) prints the one-rank test ELBO and IW-LL, at a test batch
        of 45 that the 128 test images do not divide (46 over two ranks:
        the last batch padded and masked); rank 0 alone prints."""
        from lvae_tpu_torch.evaluate import main

        args = ["--load", str(one_rank), "--device", "cpu", "--ll", "--iw-samples", "3",
                "--iw-chunk", "3", "--test-batch-size", "45", "--nimages", "4"]
        one = main(args)
        capfd.readouterr()
        assert main(args + ["--num-data-shards", "2"]) is None
        text = capfd.readouterr().out
        assert text.count("test elbo") == 1 and "x 2 ranks (gloo)" in text
        assert f"test elbo {one['elbo']['elbo']:.2f}  " in text
        assert f": {one['iw']['iw_ll']:.2f} nats" in text
        assert "[128 images" in text and "128 images, chunk 3" in text


class TestDataDependentInit:
    def test_every_rank_holds_one_state(self, tmp_path):
        """--data-dep-init on two ranks: every parameter and statistic,
        broadcast from rank 0 and compared on each rank, is the same, and
        bit-equal to the one-rank init on the same first batch (this
        process on one thread, as the ranks: the thread count moves the
        convolutions' sums)."""
        from lvae_tpu_torch.config import TrainConfig
        from lvae_tpu_torch.data.registry import load_dataset
        from lvae_tpu_torch.train.trainer import Experiment

        config = dict(dataset="synthetic", zdims=(3, 3), blocks_per_layer=1, n_filters=8,
                      skip=True, gated=True, batch_size=16, data_dep_init=True, seed=3)
        got = launch_cases({"init": {"kind": "init",
                                     "config": {**config, "num_data_shards": 2}}},
                           2, TIMEOUT_S)
        assert got["init"]["same"]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            exp = Experiment(TrainConfig(**config), torch.device("cpu"),
                             data=load_dataset("synthetic"))
            exp.init_state()
        finally:
            torch.set_num_threads(threads)
        for k, v in exp.model.state_dict().items():
            assert torch.equal(got["init"]["state_dict"][k], v), k


class TestEvaluateOutOfMemory:
    def _run_dir(self, tmp_path):
        from lvae_tpu_torch.config import TrainConfig
        from lvae_tpu_torch.data.registry import load_test_set
        from lvae_tpu_torch.train.checkpoint import save_config
        from lvae_tpu_torch.train.trainer import make_model

        cfg = TrainConfig(dataset="synthetic", zdims=(3, 3), blocks_per_layer=1, n_filters=8)
        save_config(str(tmp_path), cfg)
        model = make_model(cfg, load_test_set("synthetic"), torch.device("cpu"))
        torch.save(model.state_dict(), tmp_path / "w.pt")
        return ["--load", str(tmp_path), "--state-dict", str(tmp_path / "w.pt"), "--device",
                "cpu", "--ll", "--iw-samples", "4"]

    def test_names_the_flags_at_chunk_above_one(self, tmp_path, monkeypatch):
        """An out-of-memory error in the IW sweep at --iw-chunk > 1 exits
        naming --iw-chunk and --test-batch-size (lvae_tpu/evaluate.py:
        169-185); at chunk 1 it propagates as it came."""
        import lvae_tpu_torch.eval.iwll as iwll
        from lvae_tpu_torch.evaluate import main

        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")

        monkeypatch.setattr(iwll, "evaluate_iwll", oom)
        args = self._run_dir(tmp_path)
        with pytest.raises(SystemExit, match=r"--iw-chunk 2.*--test-batch-size") as e:
            main(args + ["--iw-chunk", "2"])
        assert "Tried to allocate 9 GiB" in str(e.value)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            main(args + ["--iw-chunk", "1"])
