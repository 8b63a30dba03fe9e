"""The examples' PyTorch/CUDA twins (``examples/*_torch.py``) run on the
CPU at smoke size through the port's API, as the JAX package's examples
run; and the train driver's ``--autotune``, the reference's flag, parses
and logs that 0 kernel cells are tuned."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.launch import train as ttrain

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin():
    losses = _example("quickstart_torch").main(["--device", "cpu",
                                                "--steps", "3"])
    assert len(losses) == 3 and all(0 < x < 10 for x in losses)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-1.5b", "rwkv6-3b"])
def test_serve_decode_twin(arch):
    out = _example("serve_decode_torch").main([arch, "--device", "cpu"])
    assert tuple(out.shape) == (4, 12)


def test_finetune_lora_twin():
    # the example asserts BK == opacus on the adapters and zero base grads
    losses = _example("finetune_lora_dp_torch").main(["--device", "cpu",
                                                      "--steps", "4"])
    assert losses[-1] < losses[0]


def test_train_dp_lm_twin(tmp_path):
    # the example asserts the loss decreases over the run
    losses = _example("train_dp_lm_torch").main(
        ["--smoke", "--device", "cpu", "--steps", "10", "--ckpt-dir",
         str(tmp_path / "ck")])
    assert len(losses) == 10
    assert any((tmp_path / "ck").iterdir())


@pytest.mark.parametrize("flag,logged", [("on", True), ("auto", False),
                                         ("off", False)])
def test_autotune_flag_parses_and_logs(flag, logged):
    kwargs, _ = ttrain.cli_args(["--smoke", "--device", "cpu", "--steps",
                                 "1", "--batch", "2", "--seq", "8",
                                 "--autotune", flag])
    assert kwargs["tc"].autotune == flag
    lines = []
    ttrain.train(**kwargs, log=lines.append, digest=False)
    assert (ttrain.AUTOTUNE_NOTE in lines) == logged
    assert "0 kernel cells tuned" in ttrain.AUTOTUNE_NOTE


def test_autotune_flag_takes_the_references_choices():
    with pytest.raises(SystemExit):
        ttrain.cli_args(["--smoke", "--autotune", "sometimes"])
    assert ttrain.cli_args(["--smoke"])[0]["tc"].autotune == "auto"
