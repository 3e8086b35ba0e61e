"""GPT-2 model, weight conversion and serving phases."""
