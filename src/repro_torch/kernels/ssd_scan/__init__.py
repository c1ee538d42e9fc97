"""SSD chunked-scan kernel (CUDA, ``csrc/ssd_scan.cu``)."""
