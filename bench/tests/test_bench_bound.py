"""The op-bound counts of bench/bound.py against counts made by hand at
N = 8 (a transform is 8/2 * 3 = 12 products), level 2 (3 limbs), digits
of 2 limbs (so 2 digits: 2 limbs and 1), k = 2 special limbs, batch 2."""
import pytest

from bench import bound

N, K, ALPHA, B = 8, 2, 2, 2


def test_transform_and_digits():
    assert bound.transform(8) == 12
    assert bound.digits(2, 2) == [2, 1]
    assert bound.digits(20, 6) == [6, 6, 6, 3]


def test_keyswitch_by_hand():
    # ModUp INTT 3*12; digit of 2: BConv 2*3*8 + NTT 3*12 + MAC 2*5*8;
    # digit of 1: BConv 1*4*8 + NTT 4*12 + MAC 2*5*8; ModDown: INTT
    # 2*2*12 + BConv 2*2*3*8 + NTT 2*3*12 + times P^-1 2*3*8
    assert bound.keyswitch_products(N, 2, K, ALPHA) == (
        36 + (48 + 36 + 80) + (32 + 48 + 80) + (48 + 96 + 72 + 48))
    assert bound.keyswitch_products(N, 2, K, ALPHA) == 624


def test_rescale_by_hand():
    # two components: INTT of the last limb, NTT into 2 limbs, 2*8
    assert bound.rescale_products(N, 2) == 2 * (12 + 24 + 16)


@pytest.mark.parametrize("kind, lin, lout, prods, nbytes", [
    # tensor 3*3*8 + keyswitch 624 + rescale 104 a row; 2 inputs of
    # 2*3*8*4 bytes and an output of 2*2*8*4 a row; key 2*2*5*8*4
    ("hmul", [2, 2], 1, 2 * (72 + 624 + 104), 2 * (2 * 192 + 128) + 640),
    ("rotate", [2], 2, 2 * 624, 2 * 2 * 192 + 640),
    ("conjugate", [2], 2, 2 * 624, 2 * 2 * 192 + 640),
    # 2*3*8 products and the rescale a row; the plaintext 3*8*4 once
    ("pmul", [2], 1, 2 * (48 + 104), 2 * (192 + 128) + 96),
    ("pmul", [2], 2, 2 * 48, 2 * (192 + 192) + 96),
    ("hadd", [1, 2], 1, 0, 2 * 3 * 128),
    ("hsub", [1, 1], 1, 0, 2 * 3 * 128),
    ("padd", [2], 2, 0, 2 * 2 * 192 + 96),
    ("rescale", [2], 1, 2 * 104, 2 * (192 + 128)),
])
def test_op_work_by_hand(kind, lin, lout, prods, nbytes):
    assert bound.op_work(kind, N, B, lin, lout, K, ALPHA) == (prods, nbytes)


def test_rotation_by_zero_and_unknown_kind():
    assert bound.op_work("rotate", N, B, [2], 2, K, ALPHA, moves=False) \
        == (0, 0)
    assert bound.op_work("bootstrap", N, B, [2], 2, K, ALPHA) is None


def test_seconds_takes_the_larger_bound():
    assert bound.seconds(0, 3.35e12) == pytest.approx(1.0)
    assert bound.seconds(bound.INT_MUL_PER_S, 1) == pytest.approx(1.0)
    assert bound.INT_MUL_PER_S == pytest.approx(64 * 132 * 1.98e9)
