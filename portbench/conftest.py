"""The program's registry as a traced run leaves it, for the tests that
build a result line from a stand-in run (`tests/test_portbench_result.py`).

The stand-in run is a dict, but the readers of the program's own spans
(`metrics/forward_ms.train.py` and kin) read the process's registry
(`tunevlseg_torch/utils/profiling.py`), which no dict fills. Those tests get
a registry holding one unprofiled group of two steps and two gaps between
groups, and an empty one after."""
import pytest

RESULT_TESTS = {"test_portbench_result.py"}


@pytest.fixture(autouse=True)
def program_registry(request):
    if request.path.name not in RESULT_TESTS:
        yield
        return
    from tunevlseg_torch.utils import profiling
    profiling.reset()
    reg = profiling.registry()
    reg.unprofiled = {"group": 1, "spans": {"step.forward": [21.9, 21.8],
                                            "step.backward": [3.66, 3.64],
                                            "step.update": [0.42, 0.41]}}
    for index, gap in ((1, 0.38), (2, 0.37)):
        reg._record(profiling.GAP, gap, index)
    yield
    profiling.reset()
