"""Every public name of every ``rocquantum_tpu`` module has a counterpart
in the same module of ``rocquantum_tpu_torch``, or stands on ROADMAP.md's
list of what does not carry over.

A public name is one without a leading underscore that is not a module and
is defined in the JAX package (a function, class or constant of it; names
imported from typing, numpy or jax are not its surface). A name a module
imports from another module of the package is satisfied by the same name
in the port's counterpart of either module. The ROADMAP list names
``rocquantum_tpu.<module>.<name>`` patterns (``*`` matches) and whole
modules, each with its reason, in its "What does not carry over"
paragraph.
"""

import fnmatch
import importlib
import os
import pkgutil
import re
import types

import rocquantum_tpu

ROADMAP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "ROADMAP.md")
JAX, PORT = "rocquantum_tpu", "rocquantum_tpu_torch"


def _not_carried():
    """The backticked ``rocquantum_tpu.`` patterns of ROADMAP.md's "What
    does not carry over" paragraph."""
    text = open(ROADMAP).read()
    start = text.index("**What does not carry over.**")
    end = text.index("\n**", start + 1)
    return re.findall(r"`(rocquantum_tpu\.[\w.*]+)`", text[start:end])


def _jax_modules():
    """Every module of the JAX package, compiled extension modules (the
    native planners' shared libraries) left out."""
    names = [JAX]
    for info in pkgutil.walk_packages(rocquantum_tpu.__path__, JAX + "."):
        spec = importlib.util.find_spec(info.name)
        if spec.origin and spec.origin.endswith(".so"):
            continue
        names.append(info.name)
    return names


def _port_name(name):
    return PORT + name[len(JAX):]


def _public(module):
    for name in dir(module):
        if name.startswith("_"):
            continue
        value = getattr(module, name)
        if isinstance(value, types.ModuleType):
            continue
        if callable(value) and \
                getattr(value, "__module__", JAX).split(".")[0] != JAX:
            continue  # imported from typing, numpy, jax, ...
        yield name, value


def _has(module_name, name):
    try:
        return hasattr(importlib.import_module(_port_name(module_name)), name)
    except ImportError:
        return False


def _missing():
    listed = _not_carried()

    def excused(qualified):
        return any(fnmatch.fnmatchcase(qualified, p) for p in listed)

    missing = []
    for mod_name in _jax_modules():
        if excused(mod_name):
            continue
        module = importlib.import_module(mod_name)
        try:
            importlib.import_module(_port_name(mod_name))
        except ImportError:
            missing.append(mod_name)
            continue
        for name, value in _public(module):
            if excused(f"{mod_name}.{name}") or _has(mod_name, name):
                continue
            home = getattr(value, "__module__", None)
            if isinstance(home, str) and home != mod_name \
                    and home.startswith(JAX + ".") and _has(home, name):
                continue
            missing.append(f"{mod_name}.{name}")
    return missing


def test_every_public_name_has_a_counterpart_or_a_reason():
    missing = _missing()
    assert missing == [], "\n".join(missing)


def test_the_roadmap_list_names_only_what_the_port_lacks():
    """Every entry of the list matches a name or module of the JAX package
    that the port does not have, so the list cannot hide a counterpart
    that exists."""
    qualified = set()
    modules = set(_jax_modules())
    for mod_name in modules:
        qualified.add(mod_name)
        module = importlib.import_module(mod_name)
        for name, _ in _public(module):
            qualified.add(f"{mod_name}.{name}")
    for pattern in _not_carried():
        hits = fnmatch.filter(sorted(qualified), pattern)
        assert hits, f"{pattern} names nothing in the JAX package"
        for hit in hits:
            if hit in modules:
                try:
                    importlib.import_module(_port_name(hit))
                except ImportError:
                    continue
                raise AssertionError(f"{hit} exists in the port")
            mod_name, _, name = hit.rpartition(".")
            assert not _has(mod_name, name), f"{hit} exists in the port"
