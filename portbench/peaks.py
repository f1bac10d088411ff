"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates), by the name torch.cuda.get_device_name() gives."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM5
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind, key):
    return PEAKS.get(kind, {}).get(key)
