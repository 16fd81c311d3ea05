"""The port's logging and its new knobs against the JAX package's
(``horovod_tpu/utils/logging.py``, ``horovod_tpu/utils/envs.py``), in this
process: the same level from ``HVD_LOG_LEVEL`` (TRACE = 5), the same line
format with and without ``HVD_LOG_TIMESTAMP``, and the same reading of a
boolean knob."""

import logging

import pytest


@pytest.fixture
def loggers():
    """Both packages' logging modules, each rebuilt on first use in the
    test and put back as they were after it."""
    from horovod_tpu.utils import logging as ref
    from horovod_tpu_torch.utils import logging as ours
    saved = []
    for mod, name in ((ref, "horovod_tpu"), (ours, "horovod_tpu_torch")):
        lg = logging.getLogger(name)
        saved.append((mod, mod._logger, lg, list(lg.handlers), lg.level))
        mod._logger = None
        lg.handlers.clear()
    yield ref, ours
    for mod, old, lg, handlers, level in saved:
        mod._logger = old
        lg.handlers[:] = handlers
        lg.setLevel(level)


def _rebuild(mods):
    """Each module's logger built anew from the environment, with its new
    handler only."""
    out = []
    for mod in mods:
        mod._logger = None
        lg = mod.get_logger()
        del lg.handlers[:-1]
        out.append(lg)
    return out


@pytest.mark.parametrize("level", ["trace", "debug", "info", "warning",
                                   "error", "fatal", "TRACE", "bogus", None])
def test_level_matches_jax(loggers, monkeypatch, level):
    if level is None:
        monkeypatch.delenv("HVD_LOG_LEVEL", raising=False)
        monkeypatch.delenv("HOROVOD_LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("HVD_LOG_LEVEL", level)
    ref, ours = _rebuild(loggers)
    assert ours.level == ref.level
    assert ours.name == "horovod_tpu_torch" and not ours.propagate
    assert logging.getLevelName(5) == "TRACE"


@pytest.mark.parametrize("stamp", ["1", "0", None])
def test_format_matches_jax(loggers, monkeypatch, stamp):
    """The same line format, the package's tag aside."""
    if stamp is None:
        monkeypatch.delenv("HVD_LOG_TIMESTAMP", raising=False)
        monkeypatch.delenv("HOROVOD_LOG_TIMESTAMP", raising=False)
    else:
        monkeypatch.setenv("HVD_LOG_TIMESTAMP", stamp)
    ref, ours = _rebuild(loggers)
    fmt = lambda lg: lg.handlers[0].formatter._fmt
    assert fmt(ours) == fmt(ref).replace("[hvd-tpu]", "[hvd-torch]")


def test_log_writes_at_each_level(loggers, monkeypatch, capsys):
    """``log("trace", ...)`` and the helpers write at and above the level
    set, and not below it."""
    monkeypatch.setenv("HVD_LOG_LEVEL", "trace")
    monkeypatch.setenv("HVD_LOG_TIMESTAMP", "0")
    _, ours = loggers
    ours._logger = None
    ours.log("trace", "t %d", 1)
    ours.debug("d")
    ours.warning("w %s", "x")
    err = capsys.readouterr().err.splitlines()
    assert err == ["[hvd-torch] [TRACE] t 1", "[hvd-torch] [DEBUG] d",
                   "[hvd-torch] [WARNING] w x"]
    monkeypatch.setenv("HVD_LOG_LEVEL", "error")
    _rebuild([ours])
    ours.info("hidden")
    ours.error("shown")
    assert capsys.readouterr().err.splitlines() == [
        "[hvd-torch] [ERROR] shown"]


@pytest.mark.parametrize("value", ["1", "true", "Yes", " on ", "0", "no",
                                   "", None])
def test_get_bool_matches_jax(monkeypatch, value):
    from horovod_tpu.utils import envs as ref
    from horovod_tpu_torch.utils import envs as ours
    for name in ("SPARSE_AS_DENSE", "DYNAMIC_PROCESS_SETS"):
        monkeypatch.delenv("HOROVOD_" + name, raising=False)
        if value is None:
            monkeypatch.delenv("HVD_" + name, raising=False)
        else:
            monkeypatch.setenv("HVD_" + name, value)
        for default in (False, True):
            assert ours.get_bool(getattr(ours, name), default) == \
                ref.get_bool(getattr(ref, name), default)
    assert (ours.LOG_LEVEL, ours.LOG_TIMESTAMP) == (ref.LOG_LEVEL,
                                                    ref.LOG_TIMESTAMP)
