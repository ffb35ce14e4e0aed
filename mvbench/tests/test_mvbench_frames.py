import torch

from mvbench.harness.frames import make_ring, pan_offsets, up3


def test_ring_repeats_for_a_seed_and_differs_for_another():
    big = 2 ** 31 + 977
    a = make_ring(big, 40, 64, 1.0, "cpu", n=4)
    b = make_ring(big, 40, 64, 1.0, "cpu", n=4)
    c = make_ring(big + 1, 40, 64, 1.0, "cpu", n=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert all(x.shape == (40, 128, 3) and x.dtype == torch.uint8 for x in a)


def test_frames_of_a_ring_are_distinct():
    ring = make_ring(5, 40, 64, 1.0, "cpu", n=6)
    for i in range(len(ring)):
        for j in range(i):
            assert not torch.equal(ring[i], ring[j])


def test_offsets_take_one_stratum_each():
    g = torch.Generator().manual_seed(3)
    offs = pan_offsets(16, (1152, 1920), g, "cpu")
    for axis, size in enumerate((1152, 1920)):
        strata = sorted(o[axis] * 16 // size for o in offs)
        assert strata == list(range(16))


def test_noise_is_per_eye_and_small():
    quiet = make_ring(9, 32, 48, 0.0, "cpu", n=2)
    noisy = make_ring(9, 32, 48, 1.0, "cpu", n=2)
    d = noisy[0].to(torch.int32) - quiet[0].to(torch.int32)
    assert d.abs().max() <= 6
    left, right = d[:, :48], d[:, 48:]
    assert not torch.equal(left, right)


def test_up3_keeps_the_corners():
    img = torch.arange(2 * 3 * 3, dtype=torch.uint8).reshape(2, 3, 3)
    up = up3(img)
    assert up.shape == (6, 9, 3)
    assert torch.equal(up[0, 0], img[0, 0])
    assert torch.equal(up[-1, -1], img[-1, -1])
