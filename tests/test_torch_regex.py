"""The port's regex transpiler and DFA walk against the JAX package's.

For every pattern of tests/test_regex.py (read from its source: the
PATTERNS list, the parametrized patterns, the dialect cases and the
literal arguments of compile_search and rlike), the port's compile_search
gives the same tables (table, classes, accept, start) as the reference's,
or raises RegexUnsupported where the reference does. The DFA walk
(ops/regexops.py dfa_match, kernel K18's plain version on the CPU) equals
the reference's on a seeded byte matrix with nulls, empty rows and dead
rows, and the transpiler's limits come from the port's active session.
"""

import ast
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import regexops as jax_regexops
from spark_rapids_tpu.regex import RegexUnsupported as JaxUnsupported
from spark_rapids_tpu.regex import compile_search as jax_compile
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.ops import regexops as port_regexops
from spark_rapids_tpu_torch.regex import RegexUnsupported as PortUnsupported
from spark_rapids_tpu_torch.regex import compile_search as port_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_test_patterns():
    """The patterns tests/test_regex.py compiles or matches."""
    src = open(os.path.join(REPO, "tests", "test_regex.py")).read()
    tree = ast.parse(src)
    out = []

    def consts(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append(node.value)
        elif isinstance(node, (ast.List, ast.Tuple)):
            for e in node.elts:
                if isinstance(e, ast.Tuple) and e.elts:
                    consts(e.elts[0])  # (pattern, inputs, oracle) cases
                else:
                    consts(e)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in ("PATTERNS", "CASES")
                for t in node.targets):
            consts(node.value)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("compile_search", "rlike") and node.args:
                consts(node.args[-1] if name == "rlike" else node.args[0])
            elif (name == "parametrize" and len(node.args) == 2
                  and isinstance(node.args[0], ast.Constant)
                  and node.args[0].value == "pattern"):
                consts(node.args[1])
    return sorted(set(out))


PATTERNS = _reference_test_patterns()


def test_every_reference_pattern_is_read():
    assert len(PATTERNS) >= 40
    for p in (r"abc", r"[A-Z][a-z]*", r"(a)\1", "\\cj", "^a|b",
              "[a-z&&[^aeiou]]+", r"^id-\d+$"):
        assert p in PATTERNS, p


@pytest.mark.parametrize("pattern", PATTERNS)
def test_transpiler_tables_match_reference(pattern):
    try:
        want = jax_compile(pattern)
    except JaxUnsupported as e:
        with pytest.raises(PortUnsupported) as err:
            port_compile(pattern)
        assert str(err.value) == str(e)
        return
    got = port_compile(pattern)
    for leaf in ("table", "classes", "accept"):
        w, g = getattr(want, leaf), getattr(got, leaf)
        assert g.dtype == w.dtype, leaf
        np.testing.assert_array_equal(g, w, err_msg=leaf)
    assert got.start == want.start and got.pattern == want.pattern


def _matrix(rng, n, mb):
    """Seeded rows over a small alphabet, zero past each length; null rows
    length 0."""
    alphabet = np.frombuffer(b"abcxyz019 .@-_\n\xc3\xa9", dtype=np.uint8)
    lengths = rng.integers(0, mb + 1, n).astype(np.int32)
    lengths[rng.random(n) < 0.1] = 0
    data = alphabet[rng.integers(0, len(alphabet), (n, mb))]
    data[np.arange(mb)[None, :] >= lengths[:, None]] = 0
    return data.astype(np.uint8), lengths


@pytest.mark.parametrize("pattern", [
    r"abc", r"a.c", r"^ab", r"[0-9]+$", r"x|y|z", r"^$", r"\.com$",
    r"(ab|cd)+e", "special.*requests", r"a{2,}b", r"[^0-9]+$"])
def test_dfa_match_matches_reference(pattern):
    import jax.numpy as jnp

    rng = np.random.default_rng(len(pattern) * 31 + 7)
    data, lengths = _matrix(rng, 1500, 16)
    # the last rows dead: random bytes past num_rows walk like any other
    want = np.asarray(jax_regexops.dfa_match(
        jnp.asarray(data), jnp.asarray(lengths), jax_compile(pattern)))
    got = port_regexops.dfa_match(torch.from_numpy(data),
                                  torch.from_numpy(lengths),
                                  port_compile(pattern))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_tables_mark_absorbing_accepts():
    """K18 stops a row at an absorbing accept state (accept 2): the
    unanchored-end pattern's accept states loop back on every class."""
    rx = port_compile("ab")
    classes, table, accept = port_regexops.device_tables(
        rx, torch.device("cpu"))
    assert table.dtype == torch.int16 and classes.dtype == torch.int16
    assert classes.shape == (256,)
    absorbing = accept.numpy() == 2
    assert absorbing.any()
    for s in np.flatnonzero(absorbing):
        assert (rx.table[s] == s).all() and rx.accept[s]
    anchored = port_compile("ab$")
    _, _, acc = port_regexops.device_tables(anchored, torch.device("cpu"))
    assert (acc.numpy() == 2).sum() == 0 and (acc.numpy() == 1).any()
    assert port_regexops.device_tables(rx, torch.device("cpu"))[1] is table


def test_transpiler_reads_the_ports_active_session():
    spark = TpuSparkSession({"spark.rapids.torch.device": "cpu",
                             "spark.rapids.sql.regexp.maxStates": 4})
    try:
        with pytest.raises(PortUnsupported, match="exceeds 4 states"):
            port_compile("abcdefgh")
        assert port_compile("abcdefgh", loose_limits=True).n_states > 4
        assert spark.ignored_settings == []
    finally:
        spark.stop()
    assert port_compile("abcdefgh").n_states > 4
