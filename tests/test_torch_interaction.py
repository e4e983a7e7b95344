"""The port's InteractionEnv (etcd_tpu_torch/harness/interaction.py): the
datadriven command scripts of tests/interaction_scripts/ (one per golden of
tests/test_datadriven_interaction.py, whose reference goldens are not in
this checkout) replayed through it on the CPU, every command's output text
equal to the JAX package's, held in RAWNODE_PIN.json ("interaction"); the
slow twin runs the JAX InteractionEnv live. Each test builds its own
environment."""
import json

import pytest
import torch

from etcd_tpu_torch.harness import rawnode_session as S

from make_rawnode_pins import jax_package
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

PIN = json.loads(S.PIN.read_text())


def first_difference(got, want) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"command {i}:\n-- port --\n{g}\n-- JAX --\n{w}"
    return f"{len(got)} commands against {len(want)}"


@pytest.mark.parametrize("fname", S.interaction_names())
def test_interaction_script_equals_pin(fname):
    got = S.run_interaction(S.port_package("cpu"), fname)
    want = PIN["interaction"][fname]
    assert got == want, first_difference(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("fname", S.interaction_names())
def test_interaction_script_equals_jax_live(fname):
    want = S.run_interaction(jax_package(), fname)
    got = S.run_interaction(S.port_package("cpu"), fname)
    assert got == want, first_difference(got, want)


def test_every_golden_has_a_script():
    from test_datadriven_interaction import GOLDENS

    assert S.interaction_names() == sorted(GOLDENS)
    assert sorted(PIN["interaction"]) == sorted(GOLDENS)


def test_env_defaults_to_cuda():
    from etcd_tpu_torch.harness.interaction import InteractionEnv

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default does not raise here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InteractionEnv()
