"""Trace reduction (utils.profiling.device_time) on a small recorded
trace, and its interval union."""
import jax
import jax.numpy as jnp
import pytest

from wah_tpu.utils.profiling import _is_host_copy, _union_ns, device_time, trace


def test_union_of_overlapping_intervals():
    assert _union_ns([]) == 0
    assert _union_ns([(0, 10), (5, 15), (20, 25)]) == 20
    assert _union_ns([(20, 25), (0, 10), (2, 3)]) == 15


@pytest.mark.parametrize("name,host_copy", [
    ("MemcpyH2D", True),
    ("MemcpyD2H", True),
    ("Stream #14(MemcpyH2D)", True),
    ("Stream #13", False),
    ("MemcpyD2D", False),
    ("input_scatter_fusion", False),
])
def test_host_copies_are_not_device_time(name, host_copy):
    """Copies between host and device (events, and the stream lines that
    hold only them) are left out of a plane's busy time."""
    assert _is_host_copy(name) is host_copy


def test_device_time_reads_a_recorded_trace(tmp_path):
    f = jax.jit(lambda x: jnp.cumsum(x) * 2)
    x = jnp.ones(1 << 16)
    f(x).block_until_ready()
    with trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    planes = device_time(str(tmp_path), prefix="/host:CPU")
    (plane,) = planes.values()
    assert 0 < plane["busy_s"] <= plane["span_s"]
    assert plane["kernels"] and plane["lines"]
    assert device_time(str(tmp_path)) == {}  # no GPU plane on the CPU
