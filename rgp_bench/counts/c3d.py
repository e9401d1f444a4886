"""The C3D tower to conv5b: eight 3x3x3 SAME convs on 16-frame clips,
cropped to 112x112, with the pools (1,2,2) after conv1a and (2,2,2) after
conv2a, conv3b and conv4b."""

from __future__ import annotations

LAYERS = ("conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b",
          "conv5a", "conv5b")
POOL_AFTER = {"conv1a": (1, 2, 2), "conv2a": (2, 2, 2), "conv3b": (2, 2, 2),
              "conv4b": (2, 2, 2)}


def layer_inputs(channels, window: int = 16, crop: int = 112) -> list:
    """(name, (D, H, W, Cin), Cout) of each conv for one clip."""
    d, h, w, cin, out = window, crop, crop, 3, []
    for name, cout in zip(LAYERS, channels):
        out.append((name, (d, h, w, cin), cout))
        cin = cout
        if name in POOL_AFTER:
            sd, sh, sw = POOL_AFTER[name]
            d, h, w = -(-d // sd), -(-h // sh), -(-w // sw)
    return out


def ops(channels, clips: int, window: int = 16, crop: int = 112) -> int:
    """The convs' operations for `clips` clips."""
    return clips * sum(2 * d * h * w * cout * 27 * cin for _, (d, h, w, cin),
                       cout in layer_inputs(channels, window, crop))


def conv5b_elements(channels, clips: int, window: int = 16,
                    crop: int = 112) -> int:
    *_, (_, (d, h, w, _), cout) = layer_inputs(channels, window, crop)
    return clips * d * h * w * cout


def int8_bytes(channels, clips: int, window: int = 16,
               crop: int = 112) -> int:
    """The int8 tower's least traffic: the quantized clips read once, the
    int8 weights with their f32 scales and biases read once, conv5b written
    once in f32. Activations between layers are not counted: a tower that
    keeps them on chip need not move them."""
    weights = sum(27 * cin * cout + 8 * cout for _, (_, _, _, cin), cout
                  in layer_inputs(channels, window, crop))
    return (clips * window * crop * crop * 3 + weights
            + 4 * conv5b_elements(channels, clips, window, crop))
