"""Federated fine-tuning of language models: LoRA adapters and FedLLM."""
