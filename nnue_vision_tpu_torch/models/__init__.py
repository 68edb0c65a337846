"""Float models (`nn.Module`s) and their quantization to engine files."""
