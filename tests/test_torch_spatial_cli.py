"""``python -m lvae_tpu_torch.main --num-data-shards 2 --spatial-shards 2``
through its launcher on the CPU: four gloo ranks trained, resumed and
evaluated, against ``main`` on one rank (fp32: parameters and the test
ELBO within 1e-4); and the data height's check. The banded modules and
steps are ``tests/test_torch_spatial.py``'s."""

import os

import numpy as np
import pytest

from lvae_tpu_torch.config import TrainConfig
from lvae_tpu_torch.models.lvae import LadderVAE
from torch_parallel_ranks import bn_fed_keys


@pytest.fixture(scope="module", autouse=True)
def _one_thread_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior", "--freebits", "0.5",
        "--batch-size", "16", "--test-batch-size", "32", "--seed", "5", "--device", "cpu",
        "--fused", "all", "--log-interval", "2", "--test-interval", "6",
        "--checkpoint-interval", "2"]


class TestCLI:
    def test_train_resume_evaluate(self, tmp_path):
        """``main --num-data-shards 2 --spatial-shards 2`` starts its four
        ranks, trains 4 steps, resumes to 6 (``--auto-resume``) and is
        scored by ``evaluate --load``; against ``main`` on one rank, 6 steps:
        the checkpoints' parameters and statistics, and the test ELBO of
        both runs within 1e-4 relative; the run name's ``sp2``."""
        from lvae_tpu_torch.evaluate import main as evaluate
        from lvae_tpu_torch.main import main
        from lvae_tpu_torch.train.checkpoint import CheckpointManager

        args = TINY + ["--output-dir", str(tmp_path)]
        sp = args + ["--run-name", "sp", "--num-data-shards", "2", "--spatial-shards", "2"]
        assert main(sp + ["--max-steps", "4"]) is None           # the launcher's ranks
        assert main(sp + ["--max-steps", "6", "--auto-resume"]) is None
        one = main(args + ["--run-name", "one", "--max-steps", "6"])
        ckpts = sorted(os.listdir(tmp_path / "sp" / "checkpoints"))
        assert ckpts == ["ckpt_00000004.pt", "ckpt_00000006.pt"]
        res = evaluate(["--load", "sp", "--output-dir", str(tmp_path), "--device", "cpu"])
        ref = evaluate(["--load", "one", "--output-dir", str(tmp_path), "--device", "cpu"])
        assert res["step"] == 6 and res["elbo"]["n_images"] == ref["elbo"]["n_images"]
        np.testing.assert_allclose(res["elbo"]["elbo"], ref["elbo"]["elbo"], rtol=1e-4)
        # the checkpoints at step 6: within 1e-4, the conv biases that only a
        # BatchNorm reads (roundoff-led) within Adamax's 2 lr a step
        got = CheckpointManager(str(tmp_path / "sp")).load(6)["model"]
        want = CheckpointManager(one.run_dir).load(6)["model"]
        led = bn_fed_keys(LadderVAE(color_ch=1, z_dims=(3, 3), downsample=(1, 1), n_filters=8,
                                    blocks_per_layer=1,
                                    stochastic_skip=True, gated=True, learn_top_prior=True,
                                    img_size=(32, 32), data_size=(28, 28)))
        for k, v in want.items():
            if v.is_floating_point():
                atol = 2 * 3e-4 * 6 if k in led else 1e-4
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol,
                                           err_msg=k)
        assert "sp2" in TrainConfig(spatial_shards=2).describe()

    def test_height_must_divide(self, tmp_path):
        """28 rows do not tile over 5 ranks: the command raises, naming the
        height, before it starts a rank."""
        from lvae_tpu_torch.main import main

        with pytest.raises(ValueError, match="image height 28 not divisible by "
                                             "--spatial-shards 5"):
            main(TINY + ["--output-dir", str(tmp_path), "--spatial-shards", "5",
                         "--max-steps", "1"])
