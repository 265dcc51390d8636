"""The card window kernels' shape limits, checked before any window runs
(``fused_chooser.ops.check_shape_limits``): pure functions of (window,
k_max) that the CPU can check, and the card sessions and sweeps that call
them — built, placed or restored, a ``Partitioner`` and a ``Sweep`` on a
CUDA device string past a limit raise naming the knob before they look for
a card; the same on the CPU, whose plain versions have no limit, run.
(The limits against the build: tests/test_torch_gpu.py.)"""
import pytest
import torch

from repro_torch.api import Partitioner, Sweep
from repro_torch.core.config import EngineConfig
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ops import check_shape_limits
from repro_torch.kernels.fused_chooser.window_prep import prep_max_w

MAX_K_256 = 9587      # large_max_k(256): the chooser binds before the fixup


@pytest.mark.parametrize("window,k_max,knob", [
    (256, 16, None), (1, 1, None), (2048, 16, None), (256, MAX_K_256, None),
    (2048, fk.large_max_k(2048), None), (1, fk.large_max_k(1), None),
    (2049, 16, "window"), (4096, 16, "window"), (4096, 20000, "window"),
    (256, MAX_K_256 + 1, "k_max"), (256, 20000, "k_max"),
    (2048, fk.large_max_k(2048) + 1, "k_max")])
def test_check_shape_limits(window, k_max, knob):
    if knob is None:
        check_shape_limits(window, k_max)
        return
    with pytest.raises(ValueError, match=f"^{knob}={window if knob == 'window' else k_max} .*lower "):
        check_shape_limits(window, k_max)


def test_limits_are_the_kernels_own():
    """The check's limits are the kernels' dispatch limits: the largest
    accepted shapes dispatch, one more raises there too."""
    assert prep_max_w() == 2048
    for w in (1, 64, 256, 2048):
        k = fk.large_max_k(w)
        assert fk.add_max_k(w) >= k
        check_shape_limits(w, k)
        assert fk.dispatch(w, k) == "large"
        assert fk.add_dispatch(w, k) == "large"
        with pytest.raises(ValueError, match="k_max"):
            check_shape_limits(w, k + 1)
        with pytest.raises(ValueError):
            fk.dispatch(w, k + 1)


def _past_the_check(make):
    """``make`` is a card session or sweep that no limit stops: it looks
    for its card, raising where there is none and running where there is."""
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


CASES = [(dict(window=4096), "window"),
         (dict(cfg=EngineConfig(k_max=MAX_K_256 + 1)), "k_max")]


@pytest.mark.parametrize("kw,knob", CASES)
def test_card_partitioner_past_a_limit_raises_when_built(tmp_path, kw, knob):
    """Built or restored (the constructor's check comes before the
    checkpoint is read: here there is none): raises naming the knob, on a
    CUDA device string and on the default device, before it looks for a
    card or allocates a state."""
    for dev in ("cuda", None):
        with pytest.raises(ValueError, match=f"{knob}=.*lower"):
            Partitioner(use_kernel=True, device=dev, **kw)
        with pytest.raises(ValueError, match=f"{knob}=.*lower"):
            Partitioner.restore(str(tmp_path / "none"), use_kernel=True,
                                device=dev, **kw)
    # the per-event engine runs no window kernel; without use_kernel the
    # card session goes on to look for its card
    for other in (dict(engine="scan", use_kernel=True),
                  dict(use_kernel=False)):
        _past_the_check(lambda: Partitioner(device="cuda", **other, **kw))


def test_card_partitioner_past_a_limit_raises_when_placed(tmp_path):
    """A CPU kernel session, which has no limit, runs at a window of 2,049;
    placing it on the card raises, and it stays on the CPU; its checkpoint
    restores on the CPU."""
    s = tstream.build_stream(tgen.make_graph("mesh", 40, 100, seed=8), seed=9)
    part = Partitioner.from_stream(s, EngineConfig(k_max=4, k_init=2),
                                   use_kernel=True, window=2049,
                                   engine="windowed", device="cpu").feed(s)
    with pytest.raises(ValueError, match="window=2049 .*lower"):
        part.place("cuda")
    assert part.device.type == "cpu" and part.cursor == s.num_events
    part.snapshot(str(tmp_path))
    part.wait()
    with pytest.raises(ValueError, match="window=2049 .*lower"):
        Partitioner.restore(str(tmp_path), EngineConfig(k_max=4, k_init=2),
                            use_kernel=True, window=2049, device="cuda")
    back = Partitioner.restore(str(tmp_path), EngineConfig(k_max=4, k_init=2),
                               use_kernel=True, window=2049, device="cpu")
    assert back.cursor == s.num_events


@pytest.mark.parametrize("window,k_max,knob", [(2049, 4, "window"),
                                               (256, MAX_K_256 + 1, "k_max")])
def test_card_sweep_past_a_limit_raises_before_stacking(window, k_max, knob):
    s = tstream.build_stream(tgen.make_graph("mesh", 40, 100, seed=8), seed=9)
    cfg = EngineConfig(k_max=k_max, k_init=2)
    sweep = Sweep(s, device="cuda").lane("sdp", cfg).windowed(window)
    with pytest.raises(ValueError, match=f"{knob}=.*lower"):
        sweep.kernel().run()
    _past_the_check(lambda: sweep.kernel(False).run())
