"""The port's LM training driver through the sharded writer fleet and from
a checkpoint directory, on the CPU, against the reference's driver (the
same setup and limits as ``test_torch_train.py``)."""
from repro.launch import train as ref_train
from repro_torch.launch import train as port_train

from test_torch_train import _two_threads  # noqa: F401  (autouse fixture)
from test_torch_train import (RUN, _configs, _init, assert_losses_close,
                              assert_policy_identical, run_both)


def test_train_through_the_inproc_fleet_with_delta_saves():
    ref, port = run_both("cpr-mfu", sharded_save=True, delta_saves=True)
    a, b = ref["report"], port["report"]
    assert b["sharded_save"] and b["writer_backend"] == "inproc"
    assert_policy_identical(a, b)
    for k in ("shard_bytes", "shard_events", "delta_rows_skipped",
              "delta_bytes_skipped", "dropped_bytes", "shard_failures"):
        assert b[k] == a[k], k
    assert_losses_close(ref, port)


def test_resume_from_a_directory(tmp_path):
    """Train 4 steps saving to a directory, then resume from it for 3 more,
    each package on its own directory: both runs' losses agree with the
    reference's."""
    cfg_ref, cfg = _configs()
    out = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        out[side] = []
        for steps, resume in ((4, False), (3, True)):
            kw = {**RUN, "steps": steps, "n_failures": 0,
                  "checkpoint_dir": d, "resume": resume}
            if side == "ref":
                _, h = ref_train.train(cfg_ref, mode="full", **kw)
            else:
                _, h = port_train.train(cfg, mode="full", device="cpu",
                                        params=_init(cfg_ref), **kw)
            out[side].append(h)
    for a, b in zip(out["ref"], out["port"]):
        assert_losses_close(a, b)
    # the resumed run starts from the saved weights, not the initial ones
    assert out["port"][1]["loss"][0][1] != out["port"][0]["loss"][0][1]
