"""``gate_mutants.py``'s broken forms still apply to the sources they
break: each kernel mutant's text is in its CUDA source exactly once, and
each host mutant patches its function in and puts it back (its edit's
text is in the function exactly once). A refactor that moves such a text
would otherwise surface only on the card, as ``gate_mutants`` exiting
before any gate runs.
"""
import importlib
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

gm = importlib.import_module("gate_mutants")

HOST_TABLES = ("HOST_MUTANTS", "DISAGG_MUTANTS", "LOWP_MUTANTS",
               "CONTROL_MUTANTS", "DEPLOY_MUTANTS", "P17_MUTANTS",
               "P18_MUTANTS", "P19_MUTANTS", "P20_MUTANTS", "P21_MUTANTS",
               "P22_MUTANTS")


def _kernel_texts_once(table, lib):
    from paddle_tpu_torch.ops import kernels

    source = os.path.join(os.path.dirname(kernels.__file__),
                          kernels.SOURCES[lib][0])
    text = open(source).read()
    for name, subs in table[lib].items():
        for old, _ in subs or ():
            assert text.count(old) == 1, (lib, name, old)


@pytest.mark.parametrize("lib", sorted(gm.MUTANTS))
def test_kernel_mutants_find_their_text_once(lib):
    _kernel_texts_once(gm.MUTANTS, lib)


@pytest.mark.parametrize("lib", sorted(gm.P21_KERNEL_MUTANTS))
def test_phase21_kernel_mutants_find_their_text_once(lib):
    _kernel_texts_once(gm.P21_KERNEL_MUTANTS, lib)


@pytest.mark.parametrize("table", HOST_TABLES)
def test_host_mutants_patch_in_and_restore(table):
    mutants = getattr(gm, table)
    for name, spec in mutants.items():
        if spec is None:
            continue
        module, qual, _ = spec
        owner = importlib.import_module(module)
        if "." in qual:
            cls, attr = qual.split(".")
            owner = getattr(owner, cls)
        else:
            attr = qual
        real = owner.__dict__[attr]
        restore = gm.host_variant(name, mutants)
        assert owner.__dict__[attr] is not real, name
        restore()
        assert owner.__dict__[attr] is real, name
