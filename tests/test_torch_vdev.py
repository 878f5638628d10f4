"""Self-tests of the virtual-device harness (``tests/torch_vdev.py``): it
raises where torch raises for two real devices, lets through what torch
lets through, and moves data only where torch moves it."""

import numpy as np
import pytest
import torch

from torch_vdev import VirtualDevices, device_of, to_numpy, vdev, \
    virtual_devices

D1, D2 = vdev(1), vdev(2)


def test_factories_place_and_report_their_device():
    with virtual_devices():
        a = torch.zeros(3, device="cpu:1")
        b = torch.empty((2, 2), device=D2)
        h = torch.ones(3)
        assert (a.device, b.device, h.device) == (D1, D2, torch.device("cpu"))
        assert torch.full_like(a, 2.0).device == D1
        assert torch.full_like(a, 2.0, device=D2).device == D2
        assert a.new_zeros(4).device == D1
        assert torch.as_tensor(np.ones(2), device=D2).device == D2
        assert torch.from_numpy(np.ones(2)).device == torch.device("cpu")
    assert device_of(a) == D1 and device_of(h) == torch.device("cpu")


def test_every_other_op_keeps_its_inputs_device():
    with virtual_devices():
        a = torch.arange(6.0, device=D1).reshape(2, 3)
        for out in (a + 1, a[1:], a.T, a.sum(0), torch.sort(a, 1).values,
                    torch.sort(a, 1).indices, torch.stack([a, a]),
                    torch.where(a > 2, a, 0.0), a.to(torch.float64),
                    a.contiguous().view(-1), a.clone(), a.detach()):
            assert out.device == D1
        assert [r.device for r in a] == [D1, D1]
        assert a.to(D1) is a


@pytest.mark.parametrize("other", ["cpu:2", "cpu"])
def test_a_mixed_device_op_raises(other):
    """Two virtual devices, or a virtual device and the host, in one op:
    torch's error for cuda:0 and cuda:1 (or the host)."""
    with virtual_devices():
        a = torch.ones(3, device=D1)
        b = torch.ones(3, device=other)
        for op in (lambda: a + b, lambda: torch.cat([a, b]),
                   lambda: torch.where(a > 0, b, a),
                   lambda: torch.stack([a, b]), lambda: a.copy_(b).add_(b)):
            with pytest.raises(RuntimeError, match="same device"):
                op()
        with pytest.raises(RuntimeError, match="same device"):
            a[torch.tensor([0, 1], device="cpu:3")]


def test_numpy_of_a_virtual_device_tensor_raises():
    with virtual_devices():
        a = torch.ones(3, device=D1)
        with pytest.raises(TypeError, match="cpu:1"):
            a.numpy()
        with pytest.raises(TypeError, match="cpu:1"):
            np.asarray(a)
        assert np.asarray(a.cpu()).tolist() == [1.0] * 3
        assert np.asarray(torch.ones(2)).tolist() == [1.0, 1.0]
        # reading a value is a synchronising copy, allowed as on a card
        assert float(a[0]) == 1.0 and a.sum().item() == 3.0
    assert to_numpy(a).tolist() == [1.0] * 3


def test_copy_and_to_move_data_between_devices():
    with virtual_devices() as vd:
        a = torch.arange(3.0, device=D1)
        b = torch.zeros(3, device=D2)
        assert b.copy_(a) is b and b.device == D2
        assert to_numpy(b).tolist() == [0.0, 1.0, 2.0]
        c = a.to(D2)
        assert c.device == D2 and c is not a
        c.add_(1)
        assert to_numpy(a).tolist() == [0.0, 1.0, 2.0]
        h = a.cpu()
        assert h.device == torch.device("cpu") and h is not a
        h.zero_()
        assert to_numpy(a).tolist() == [0.0, 1.0, 2.0]
        back = h.to(D1)
        assert back.device == D1
        d = torch.zeros(3, device=D2)
        d[1:] = a[:2]
        assert to_numpy(d).tolist() == [0.0, 0.0, 1.0]
        assert vd.counts["moves"] >= 4


def test_a_host_scalar_tensor_mixes_as_torch_allows():
    """A 0-dim host tensor mixes with any device's tensor (torch's CPU
    scalar); a 0-dim tensor on a device does not mix with the host's, and
    host index tensors index any device's tensor."""
    with virtual_devices():
        a = torch.ones(3, device=D1)
        s = torch.tensor(2.0)
        assert (a * s).device == D1 and torch.maximum(a, s).device == D1
        with pytest.raises(RuntimeError, match="same device"):
            torch.ones(3) + a.sum()
        assert a[torch.tensor([0, 2])].device == D1
        a[torch.tensor([True, False, True])] = 5.0
        assert to_numpy(a).tolist() == [5.0, 1.0, 5.0]


def test_the_mode_ends_with_its_block():
    mode = VirtualDevices()
    with mode:
        a = torch.ones(2, device=D1)
    assert a.device == torch.device("cpu")
    assert a.numpy().tolist() == [1.0, 1.0]
