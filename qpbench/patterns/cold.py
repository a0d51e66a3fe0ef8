"""The cold pattern: ``pool`` distinct batches, drawn once at set-up and
cycled, each call independent of the last."""


def batches(cfg: dict, traffic: dict, seed: int, device, draw) -> list:
    out = []
    for p in range(int(traffic["pool"])):
        b = draw(cfg, seed, p, device)
        out.append((b, b.dense()))
    return out
