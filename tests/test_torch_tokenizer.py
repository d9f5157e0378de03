"""The port's CLIP tokenizer (stdlib `unicodedata`) against the JAX package's (`regex`)."""

import pytest

from t2v_turbo_tpu.utils.tokenizer import CLIPTokenizer as JTokenizer
from t2v_turbo_tpu_torch.utils.tokenizer import CLIPTokenizer

ASCII = [
    "An astronaut riding a horse on the moon",
    "A panda playing guitar, 4K, cinematic lighting!!",
    "it's 3:45pm -- we'll see what's next; (maybe) 100 cats_and_dogs",
    "  lots   of\twhitespace\n and &amp; html &lt;tags&gt; ",
    "x" * 400,  # truncated with EOT forced into the last slot
]
ACCENTED = [
    "Café crème brûlée in Zürich, señor",
    "Ελληνικά и русский текст, 日本語のテキスト",
    "naïve façade – déjà vu ©2024 ™",
]


@pytest.fixture(scope="module")
def tokenizers():
    return CLIPTokenizer(), JTokenizer()


@pytest.mark.parametrize("prompt", ASCII + ACCENTED)
def test_ids_equal_the_jax_tokenizer(tokenizers, prompt):
    port, ref = tokenizers
    assert port(prompt).tolist() == ref(prompt).tolist()


def test_batch_shape_and_padding(tokenizers):
    port, ref = tokenizers
    out = port(ASCII[:2])
    assert out.shape == (2, 77) and out.dtype.name == "int32"
    assert out.tolist() == ref(ASCII[:2]).tolist()
    assert out[0, 0] == port.sot_id and port.eot_id in out[0].tolist()


@pytest.mark.parametrize("prompt", ["x² + y²", "½cup", "Ⅻth chapter", "H₂O"])
def test_documented_difference_on_non_decimal_numbers(tokenizers, prompt):
    """Superscripts, subscripts, vulgar fractions and Roman numerals are
    \\p{N} but not decimal digits: the port classes them with
    `unicodedata` and splits them from the letters they touch, as `regex`
    does, so the ids equal the JAX tokenizer's (they differed while the
    port used stdlib `\\w`); standing alone ("½ cup") they agree too."""
    port, ref = tokenizers
    assert port(prompt).tolist() == ref(prompt).tolist()
    assert port("½ cup").tolist() == ref("½ cup").tolist()
