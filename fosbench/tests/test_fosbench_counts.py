"""The copied work arithmetic reproduces chip_smoke's published counts and
hand counts of both configurations."""
from fosbench import common, counts, weights


def test_published_kernel_counts():
    # phase-7 shapes: decode B=4, 24/8 heads of 128, 1040 valid rows
    nbytes, _ = counts.decode_attention_work(4, 24, 8, 128, 1040)
    assert nbytes == 34_177_024                      # "34.2 MB"
    # SSD at mamba2-780m's layer, B=4, L=1024
    _, flops = counts.ssd_work(4, 1024, 48, 64, 1, 128, 128)
    assert flops == 8_133_279_744                    # "8.13 GFLOP"
    # causal flash at llama's forward, B=4, S=1024
    _, flops = counts.flash_work(4, 1024, 24, 8, 128)
    assert flops == 25_794_969_600                   # "25.8 GFLOP"


def test_token_params_by_hand():
    q = counts.dims(common.config("qwen3-moe-30b-a3b-16l"))
    attn = 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
    assert counts.token_params(q) == attn + 2048 * 128 + 8 * 3 * 2048 * 768
    m = counts.dims(common.config("mamba2-780m"))
    assert counts.token_params(m) == (1536 * (2 * 3072 + 256 + 48)
                                      + 3072 * 1536 + 4 * (3072 + 256))


def test_model_flops_by_hand():
    q = counts.dims(common.config("qwen3-moe-30b-a3b-16l"))
    # one token, one row: no attention beyond itself
    per_layer = 2 * 56_885_248 + 4 * 32 * 128 * 1
    assert counts.prefill_flops(q, 1, 1) == 16 * per_layer + 2 * 2048 * 151936
    # a decode step at position 9 attends over 10 rows
    step = counts.decode_step_flops(q, 2, 9)
    assert step == 2 * (16 * (2 * 56_885_248 + 4 * 32 * 128 * 10)
                        + 2 * 2048 * 151936)
    m = counts.dims(common.config("mamba2-780m"))
    f = counts.prefill_flops(m, 1, 128)
    ssd = 48 * (2 * 128 * 8256 + 48 * (2 * 64 * 8256 + 4 * 128 * 128 * 64))
    assert f == 2 * 14_636_032 * 128 * 48 + ssd + 2 * 1536 * 50277
    # the embedding lookup is not counted: the unembedding once a row
    assert counts.prefill_flops(m, 1, 1) - 2 * 1536 * 50277 == (
        2 * 14_636_032 * 48 + counts.ssd_flops(1, 1, m) * 48)


def test_parameter_counts():
    # 10.59 B and 857.8 M, as the port's configs count them
    n = weights.n_params(common.config("qwen3-moe-30b-a3b-16l"))
    assert round(n / 1e9, 2) == 10.59
    n = weights.n_params(common.config("mamba2-780m"))
    assert round(n / 1e6, 1) == 857.8


def test_bound_takes_the_longer_side():
    assert counts.bound_seconds(3.35e12, 0, counts.PEAK_TF32) == 1.0
    assert counts.bound_seconds(0, counts.PEAK_BF16, counts.PEAK_BF16) == 1.0
