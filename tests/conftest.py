def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's kernels); skipped "
        "where torch.cuda.is_available() is false. Run on the card with "
        "`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.")
