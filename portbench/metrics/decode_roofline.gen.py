"""The greedy decode kernel's share of its roofline in `generate`: the
bounds of its launches in the profiled stretch over the summed device
time of `greedy_generate_kernel`."""


from portbench import roofline


def read(run):
    p = run.profile
    if p is None or not run.shapes.decode:
        return None
    m = run.model
    bound = sum(roofline.greedy_generate(b, m["word_embed_size"],
                                         m["lstm_hidden_size"], t,
                                         m["qst_vocab_size"], d)
                for b, t, d in run.shapes.decode)
    spent = p.kernel_s("greedy_generate_kernel")
    return 100.0 * bound / spent if spent > 0 else None
