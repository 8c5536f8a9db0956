"""The port's examples (``examples/torch/*.py``) against the JAX
package's (``examples/*.py``), on the CPU.

* quickstart, placement_sweep, fleet_demo and serve_dynamic with
  ``--device cpu`` print exactly what the reference examples print.
* train_tiny with ``--steps 20``, started from the reference's initial
  params, logs every step's loss within 1e-4 of the reference's (wall
  times differ).
"""
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.models import lm  # noqa: E402

from test_torch_families import _numpy_tree  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref(name):
    return _load(os.path.join(EXAMPLES, f"{name}.py"), f"_ref_{name}")


def _port(name):
    return _load(os.path.join(EXAMPLES, "torch", f"{name}.py"),
                 f"_port_{name}")


@pytest.mark.parametrize("name", ["quickstart", "placement_sweep",
                                  "fleet_demo", "serve_dynamic"])
def test_host_examples_print_what_the_references_print(name, monkeypatch,
                                                       capsys):
    monkeypatch.setattr(sys, "argv", [name])
    _ref(name).main()
    ref = capsys.readouterr().out
    _port(name).main(["--device", "cpu"])
    ours = capsys.readouterr().out
    assert ours == ref and len(ref.splitlines()) > 5


def test_train_tiny_losses_match_the_reference(tmp_path, monkeypatch,
                                               capsys):
    runs = []
    real_run = jax_trainer.Trainer.run

    def run(self):
        runs.append(self)
        return real_run(self)
    monkeypatch.setattr(jax_trainer.Trainer, "run", run)
    monkeypatch.setattr(sys, "argv", ["train_tiny", "--steps", "20",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    _ref("train_tiny").main()
    (ref,) = runs
    p0 = _numpy_tree(jax_lm.init_lm(jax.random.PRNGKey(0), ref.model_cfg))
    monkeypatch.setattr(lm, "init_lm",
                        lambda gen, cfg: lm.params_from_numpy(p0, "cpu"))
    ours = _port("train_tiny").main(["--steps", "20", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "model: 1.1 M params; steps: 20" in out
    got = [m["loss"] for m in ours.metrics_log]
    want = [m["loss"] for m in ref.metrics_log]
    assert len(got) == len(want) == 20
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-4
