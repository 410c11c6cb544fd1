"""Shared runtime utilities: structured stage logging."""
