"""Static quantization, calibration and the w8a16 serving engine."""
