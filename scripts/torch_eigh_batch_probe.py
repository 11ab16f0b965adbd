"""Which batch sizes of 4x4 symmetric matrices torch.linalg.eigh accepts on
the GPU (cuSOLVER's batched syev), the limit that tpu3d_torch/core/linalg.py
works around by chunking.

    python scripts/torch_eigh_batch_probe.py
"""
import torch


def main() -> None:
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for n in (16384, 24576, 32767, 32768, 65536):
        A = torch.randn(n, 4, 4, device=dev)
        A = A @ A.transpose(-1, -2)
        try:
            torch.linalg.eigh(A)
            torch.cuda.synchronize()
            print(f"batch {n}: ok", flush=True)
        except RuntimeError as e:
            print(f"batch {n}: refused ({str(e)[:100]})", flush=True)


if __name__ == "__main__":
    main()
