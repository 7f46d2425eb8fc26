"""Per cent of the prefill positions the traced part's admissions ran that
no real row needed: padding to the prompt class and the batch extent,
and prefixes the radix cache already held (the ``serve/admit`` spans'
``needed`` over their ``positions``)."""

from perfbench import program_spans


def read(r):
    return program_spans.admission_waste(r)
