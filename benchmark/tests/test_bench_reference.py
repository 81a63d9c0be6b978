"""The frozen reference against the port's CPU path, at reduced planes and
in f32, where the two must agree to rounding: the augmentation sample by
sample, one pce step, one dmpls step and the eval forward, each through
the harness's own drivers."""

import torch

from conftest import small_cell
from harness import check, infer, train
from reference import draws
from reference.augment import augment


def test_augment_matches_the_port_bit_for_bit():
    from wsl4mis_torch.data.augment_device import sample_policy
    from wsl4mis_torch.ops.augment import augment_batch_plain

    gen = torch.Generator().manual_seed(7)
    images = torch.randn((16, 40, 40), generator=gen)
    labels = torch.randint(0, 5, (16, 40, 40), generator=gen,
                           dtype=torch.int32)
    labels[:8] = labels[:8].clamp(max=3)
    pol_port = sample_policy(torch.Generator().manual_seed(3), labels)
    pol_ref = draws.policy(torch.Generator().manual_seed(3), 16, "cpu")
    assert torch.equal(pol_port, pol_ref)
    assert {int(b) for b in pol_ref[:, 0]} == {0, 1, 2}
    want = augment_batch_plain(images, labels, pol_port)
    got = augment(images, labels, pol_ref)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_step_draws_match_the_train_command():
    from wsl4mis_torch.engine.methods.common import rng_seeds

    seed = 2 ** 31 + 12345
    port = rng_seeds(seed, 5)
    ref = draws.step_generators(seed, 5, "cpu")
    for name, s in port.items():
        assert ref[name].initial_seed() == s


def _numbers(name, tmp_path):
    cell = small_cell(name, dtype="float32")
    s = train.Setup(cell, 2 ** 31 + 99, "cpu", str(tmp_path))
    prog = s.first_steps()
    s.release()
    return check.training_numbers(prog, s.follow())


def test_pce_steps_match_the_reference(tmp_path):
    n = _numbers("unet.pce_b24", tmp_path)
    assert n["loss"] < 1e-5 and n["grad"] < 1e-4 and n["change"] < 1e-3
    # the conv biases before a train-mode BN: left out by the rule
    assert n["_left_out"] and all(k.endswith(("conv1.bias", "conv2.bias"))
                                  for k in n["_left_out"])


def test_dmpls_steps_match_the_reference(tmp_path):
    n = _numbers("unet_cct.dmpls_b6", tmp_path)
    assert n["loss"] < 1e-5 and n["grad"] < 1e-4 and n["change"] < 1e-3


def test_eval_forward_matches_the_reference():
    cell = small_cell("unet.val_fold", dtype="float32")
    s = infer.Setup(cell, 5, "cpu")
    _, kept = s.passes(2, keep=(0,))
    s.release()
    gap, rows = s.judge(kept)
    assert len(rows) == 2 * cell.traffic["volumes"]
    assert gap < 1e-4
    assert all(p.shape == (5, 24, 32) for p in kept[0])
