def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess / multi-device)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without them")
