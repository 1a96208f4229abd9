import os

# Tests run on the CPU with a virtual 8-device mesh (sharding semantics are
# those of a multi-GPU host). The platform is pinned through jax.config as
# well as JAX_PLATFORMS, before any backend initializes, so no test process
# ever takes a GPU: `python chip_smoke.py` runs the GPU path and the tests
# marked `gpu`, one process per card.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Heaviest Monte-Carlo variants (>12s each on CPU, ~7 min total): marked slow
# so the default run (`pytest tests/ -x -q`, pytest.ini deselects them)
# finishes in ~14 min on this image's CPU while still covering every feature
# with a faster sibling test. `pytest tests/ -m slow` runs just these;
# `-m ""` runs everything.
_SLOW = {
    "test_observability.py::test_calibrated_table_matches_full_phy",
    "test_tddsim.py::test_tdd_config1_full_frame_high_snr",
    "test_fullsim.py::test_single_subframe_receive_noiseless",
    "test_tddsim.py::test_tdd_bler_point_low_snr",
    "test_tddsim.py::test_tdd_config2_dl_heavy",
    "test_bler_anchor.py::test_etu_harq_gain_ordering",
    "test_measurements_abstraction.py::test_calibrate_eesm_beta_machinery",
    "test_ulsim.py::test_ulsim_harq_gain",
    "test_fullsim.py::test_fullsim_harq_gain_fading",
    "test_si_rar_1c.py::test_rar_and_sib_via_dci_1c[2]",
    "test_sched_ul.py::test_ul_grant_harq_recovers_marginal_snr",
    "test_tddsim.py::test_tdd_dl_bler_matches_fdd_point",
    "test_tddsim.py::test_tdd_50prb_frame",
    "test_tddsim.py::test_tdd_25prb_frame",
    "test_paging.py::test_mt_attach_via_paging_over_the_air",
    "test_capstone.py::test_capstone_big_nas_segmentation",
    "test_capstone_multiue.py::test_two_ues_full_phy_attach",
    "test_capstone_multiue.py::test_two_ues_prach_collision_resolved",
    "test_bler_anchor.py::test_awgn_ladder_anchor[17-8.1-8.4-8.8]",
    "test_bler_anchor.py::test_awgn_ladder_anchor[21-10.9-11.2-11.6]",
    "test_bler_anchor.py::test_awgn_ladder_anchor[27-15.5-15.8-16.3]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        rel = item.nodeid.split("tests/")[-1]
        if rel in _SLOW:
            item.add_marker(pytest.mark.slow)
