"""The JAX CNN runner's scripts and jitted programs, for tests that hold
the port's runners against them.  ``jax_script(name)`` loads
``scripts/<name>.py`` (the JAX runner scripts are not a package).

Its jitted programs are compiled once per flax model (its repr: the
module's fields) in a test process: ``train_model`` builds its
train and eval steps and its initial state anew on every call, so tests
that run it several times on one model would compile them each time.

``patch(monkeypatch)`` points ``cliffordtpu.runners.cnn_runner``'s
``make_cnn_train_step``, ``make_cnn_eval_step`` and ``create_train_state``
at the shared ones; with ``seen``, every train step's (parameters as a
host copy, x, key, beta) is appended there.  ``created_once`` is the
shared ``create_train_state``: a copy for each call, since the train step
donates its state."""

import importlib.util
import os

import jax
import numpy as np

from cliffordtpu.runners import cnn_runner as jrunner
from cliffordtpu.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FACTORIES = {name: getattr(jrunner, name)
              for name in ("make_cnn_train_step", "make_cnn_eval_step")}
_STEPS, _STATES = {}, {}


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _copy(tree):
    return jax.tree_util.tree_map(
        lambda t: t.copy() if hasattr(t, "copy") else t, tree)


def created_once(key, model, *args, **kwargs):
    k = (repr(model), np.asarray(key).tobytes())
    if k not in _STATES:
        _STATES[k] = create_train_state(key, model, *args, **kwargs)
    return _copy(_STATES[k])


def _compiled_once(name, seen):
    def factory(model):
        if (name, repr(model)) not in _STEPS:
            _STEPS[name, repr(model)] = _FACTORIES[name](model)
        step = _STEPS[name, repr(model)]
        if seen is None:
            return step

        def recording(state, x, key, beta):
            seen.append((_copy(jax.device_get(state.params)), x, key, beta))
            return step(state, x, key, beta)
        return recording
    return factory


def patch(monkeypatch, seen=None):
    monkeypatch.setattr(jrunner, "make_cnn_train_step",
                        _compiled_once("make_cnn_train_step", seen))
    monkeypatch.setattr(jrunner, "make_cnn_eval_step",
                        _compiled_once("make_cnn_eval_step", None))
    monkeypatch.setattr(jrunner, "create_train_state", created_once)
