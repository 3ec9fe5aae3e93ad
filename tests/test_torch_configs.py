"""The port's configs equal the JAX package's, field for field, so the two
cannot drift: every arch, its reduced() form, the shape cells, RunConfig's
defaults and the registry."""
import dataclasses
import os

import pytest

from repro import configs as jc
import repro_torch.configs as tc

ARCHS = jc.ALL_ARCHS + jc.PAPER_ARCHS


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_registry_lists_match():
    assert tc.ALL_ARCHS == jc.ALL_ARCHS
    assert tc.PAPER_ARCHS == jc.PAPER_ARCHS
    assert sorted(tc.all_configs()) == sorted(jc.all_configs())
    assert len(ARCHS) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_matches(arch):
    want, got = jc.get_config(arch), tc.get_config(arch)
    assert _fields(got) == _fields(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.padded_vocab(8) == want.padded_vocab(8)
    assert tc.shapes_for(arch) == jc.shapes_for(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_matches(arch):
    assert _fields(tc.reduced(tc.get_config(arch))) == \
        _fields(jc.reduced(jc.get_config(arch)))
    kw = dict(layers=3, d_model=32, vocab=100, head_dim=8)
    assert _fields(tc.reduced(tc.get_config(arch), **kw)) == \
        _fields(jc.reduced(jc.get_config(arch), **kw))


def test_shapes_match():
    assert sorted(tc.SHAPES) == sorted(jc.SHAPES)
    for name in jc.SHAPES:
        assert _fields(tc.SHAPES[name]) == _fields(jc.SHAPES[name])
        assert tc.SHAPES[name].tokens == jc.SHAPES[name].tokens


def test_run_config_fields_and_defaults_match():
    want = [(f.name, f.default) for f in dataclasses.fields(jc.RunConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tc.RunConfig)]
    assert got == want
    # frozen and hashable in both: the config keys plan caches
    assert hash(tc.RunConfig()) is not None
    with pytest.raises(dataclasses.FrozenInstanceError):
        tc.RunConfig().seed = 1


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tc.get_config("no-such-arch")


def test_embed_impl_is_kept_for_parity_and_read_nowhere():
    """RunConfig.embed_impl exists for field parity only: the port's gather
    and scatter dispatch on the tensor's device, so no module outside the
    config reads the field."""
    assert tc.RunConfig().embed_impl == jc.RunConfig().embed_impl
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    readers = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            if not name.endswith(".py") or path.endswith(
                    os.path.join("configs", "base.py")):
                continue
            if "embed_impl" in open(path).read():
                readers.append(path)
    assert readers == []
