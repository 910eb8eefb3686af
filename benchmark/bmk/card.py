"""The card: presence, name, power limit, clocks and memory peak."""
import subprocess
import sys


def require(chips: int, device: str):
    """Exit with code 3, printing no result, unless ``chips`` CUDA cards
    are present (a run on ``device="cpu"`` is the tests' alone)."""
    import torch

    if device == "cpu":
        return
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        raise SystemExit(3)


def smi() -> str:
    """Name, power limit and clocks of each card, from nvidia-smi."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
         "clocks.mem,temperature.gpu")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return "; ".join(line.strip() for line in out.splitlines())


def device_block(device: str, count: int) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
