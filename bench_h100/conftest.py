"""The small CPU size of rvrt256 for the tests that run every cell at a
small size (bench_h100/tests/_small.py's SIZES), and the cells left out of
the two fault tests that break a cell's step through
stnls_tpu_torch.matrix_steps: those whose adapter never calls it, which
cannot be broken that way (rvrt256's tests/test_bench_h100_rvrt.py breaks
its own step the same ways)."""

from bench_h100 import common

# T 6 frames (three clips, so the _2 branches read the _1 branches'
# updated flows) of 32^2, window (2, 4, 4) over the 8^2 features
RVRT_SMALL = dict(B=1, T=6, H=32, W=32, embed_dim=24, num_heads=2,
                  attention_heads=2, window_size=[2, 4, 4], ws=3, K=4)
MATRIX_STEPS_FAULTS = ("test_an_altered_answer_is_caught",
                       "test_half_the_batch_left_out_is_caught")


def _steps_through_matrix_steps(cell):
    config = common.workload(cell)["config"]
    source = common.HERE / "configs" / f"{config}.py"
    return "matrix_steps" in source.read_text()


def pytest_collection_modifyitems(config, items):
    import _small
    _small.SIZES.setdefault("rvrt256", RVRT_SMALL)
    left_out = [i for i in items
                if i.path.name == "test_bench_h100_faults.py"
                and i.name.split("[")[0] in MATRIX_STEPS_FAULTS
                and not _steps_through_matrix_steps(
                    i.callspec.params["cell"])]
    if left_out:
        config.hook.pytest_deselected(items=left_out)
        items[:] = [i for i in items if i not in left_out]
