"""The benchmark's own tests, on the CPU: ``python -m pytest gpubench/tests -q``
from the root of the checkout (tests marked ``cuda`` skip without a card)."""
