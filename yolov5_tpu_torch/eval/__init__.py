"""Validation: metrics, COCO scoring and the evaluation loop."""
