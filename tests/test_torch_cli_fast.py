"""``run_processor --profile fast --device_resize`` of both packages on the
committed scene9700_00 (committed rehearsal checkpoints, ``--max_objs 32
--max_views 32``, float32, on the CPU), through their evals: the greedy
decode, the closed-form track boxes and the on-device resize of the raw
192x192 frames.  The bars are tests/test_torch_cli_offline.py's."""
from test_torch_cli import run_both_chains
from torch_threads import one_torch_thread  # noqa: F401


def test_fast_device_resize_chain_matches_jax(tmp_path_factory):
    run_both_chains(tmp_path_factory.mktemp("cli_fast"),
                    ["--profile", "fast", "--device_resize"])
