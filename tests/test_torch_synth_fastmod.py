"""The generator kernel's remainder without a division, held against
Python's ``%``.

``ops/synth_gen.py::fastmod_magic`` gives the multiply-high constants the
kernel divides by; ``fastmod`` repeats the kernel's arithmetic on them.  Each
span the generator draws with is a case: the noise's ``2 * noise + 1`` at
noise 18 and 40, the brightness offset's 41, the template's 196, the roll's
``2 * (size // shift_div) + 1`` at shift_div 4 and 8 and sizes 64 and 112,
and the distractor's ``2^30 - 2^26``; the numerators are the edges of uint32
and of the span, every numerator below 2^16 and 10^5 seeded random uint32s.
"""

import numpy as np
import pytest
import torch

from fedfr_tpu_torch.ops import synth_gen

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

SPANS = sorted({
    synth_gen.noise_span(18), synth_gen.noise_span(40),
    synth_gen.OFFSET_HI - synth_gen.OFFSET_LO,
    synth_gen.TEMPLATE_HI - synth_gen.TEMPLATE_LO,
    *(2 * (size // div) + 1 for size in (64, 112) for div in (4, 8)),
    synth_gen.DISTRACTOR_HI - synth_gen.DISTRACTOR_LO})


def _numerators(d: int) -> torch.Tensor:
    edges = [0, 1, d - 1, d, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    rand = np.random.default_rng(d).integers(0, 2 ** 32, 10 ** 5, dtype=np.uint64)
    return torch.cat([torch.tensor(edges, dtype=torch.int64),
                      torch.arange(1 << 16, dtype=torch.int64),
                      torch.from_numpy(rand.astype(np.int64))])


def test_spans_are_the_generators():
    assert SPANS == [17, 29, 33, 37, 41, 57, 81, 196, 2 ** 30 - 2 ** 26]


@pytest.mark.parametrize("d", SPANS)
def test_fastmod_equals_python_remainder(d):
    n = _numerators(d)
    want = torch.tensor([int(v) % d for v in n.tolist()], dtype=torch.int64)
    assert torch.equal(synth_gen.fastmod(n, d), want)
    m, a, low = synth_gen.fastmod_magic(d)
    assert 0 < m < 2 ** 32 and a in (0, m) and 2 ** low <= d < 2 ** (low + 1)


def test_fastmod_magic_edges():
    """Span 1 (noise < 0 or 0) and the largest uint32 divisor; 0 and 2^32
    are refused."""
    n = _numerators(3)
    for d in (1, 2, 2 ** 31, 2 ** 32 - 1):
        assert torch.equal(synth_gen.fastmod(n, d), n % d), d
    assert synth_gen.noise_span(0) == 1 and synth_gen.noise_span(-3) == 1
    for d in (0, 2 ** 32):
        with pytest.raises(ValueError):
            synth_gen.fastmod_magic(d)
