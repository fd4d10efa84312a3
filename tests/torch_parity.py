"""Shared helpers of the port's parity tests: each side's Param and Mission
built from the same keyword arguments, with each package's own enums, and
a fixture that runs a module's torch CPU ops on one thread."""
import enum

import pytest
import torch

from lsc_planner_tpu import config as jcfg
from lsc_planner_tpu import missions as jmis
from lsc_planner_tpu_torch import config as tcfg
from lsc_planner_tpu_torch import missions as tmis


def port_value(v):
    """A JAX-package enum member -> the port's member of the same name."""
    if isinstance(v, enum.Enum):
        return getattr(tcfg, type(v).__name__)[v.name]
    return v


def params(**kw):
    """(JAX Param, port Param) from the same keyword arguments."""
    return (jcfg.Param(**kw),
            tcfg.Param(**{k: port_value(v) for k, v in kw.items()}))


def missions(maker: str, *args, **kw):
    """(JAX Mission, port Mission) from the same generator and arguments."""
    return getattr(jmis, maker)(*args, **kw), getattr(tmis, maker)(*args,
                                                                    **kw)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The port's CPU tensors are small, and the tier-1 run puts several
    test processes on the machine's cores at once: torch's own thread pool
    in each of them only oversubscribes the cores.  Imported into a test
    module, this runs that module's torch ops on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
