"""The port's examples, each runnable with ``python -m`` and exposing
``main(argv=None)``: one prompt through ``generate()``
(``guanaco_generate``), a terminal chat (``chat_demo``), batch serving over
``PagedBatcher`` (``serve_demo``, with ``--tp N`` over N ranks), a streaming
web chat (``web_demo``) and greedy decoding of a model sharded over several
ranks (``serve_tp``).

Each reaches its model and tokenizer through the module-level helpers
``load_model`` and ``load_tokenizer`` (see ``_load``), so that a caller
without an HF checkpoint or ``transformers`` can hand in its own.  Each runs
on CUDA unless ``--device`` names another device."""
