"""Which operations of the SCF cycle capture into a CUDA graph.

    python3 tools/graph_capture_probe.py

Each probe runs in its own process (a failed capture can leave the
stream unusable): ``torch.linalg.eigh`` on one real 216x216 matrix and on
a batch of 27 complex 8x8 matrices, then everything else the graph
drivers' cycles use (``solve_ex``, autograd with where-guards, cuFFT,
``index_copy_`` at a device slot, a stable ``argsort`` with
``index_fill_``, a pinned device-to-host copy), captured and replayed.
Prints each probe's exit code and the end of its output.
"""
import subprocess
import sys

SETUP = """
import torch
print(torch.__version__, torch.version.cuda)
def capture(body):
    s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        body()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    return g
"""

PROBES = {
    "eigh_real_216": """
A = torch.randn(216, 216, device='cuda', dtype=torch.float64); A = A + A.T
out = torch.empty_like(A)
g = capture(lambda: out.copy_(torch.linalg.eigh(A)[1]))
g.replay(); torch.cuda.synchronize(); print('captured')
""",
    "eigh_complex_27x8x8": """
A = torch.randn(27, 8, 8, device='cuda', dtype=torch.complex128)
A = A + A.conj().transpose(1, 2)
out = torch.empty_like(A)
g = capture(lambda: out.copy_(torch.linalg.eigh(A)[1]))
g.replay(); torch.cuda.synchronize(); print('captured')
""",
    "cycle_ops": """
m = 8
kw = dict(device='cuda', dtype=torch.float64)
A = torch.randn(m + 1, m + 1, **kw) + 10 * torch.eye(m + 1, **kw)
rhs = torch.zeros(m + 1, **kw); rhs[m:].fill_(-1.0)
x = torch.zeros(m + 1, **kw)
it = torch.zeros((), dtype=torch.int64, device='cuda')
hist = torch.zeros(m, 16, **kw)
rho0 = torch.rand(4096, **kw) + 0.1
vout = torch.empty_like(rho0)
flag = torch.zeros((), dtype=torch.bool, device='cuda')
flag_host = torch.zeros((), dtype=torch.bool).pin_memory()
f = torch.randn(16, 16, 16, device='cuda', dtype=torch.complex128)
fo = torch.empty_like(f)
ev = torch.randn(27 * 8, **kw); occ = torch.empty_like(ev)
def body():
    x.copy_(torch.linalg.solve_ex(A, rhs)[0])
    hist.index_copy_(0, torch.remainder(it, m).reshape(1), torch.ones(1, 16, **kw) * it)
    it.add_(1)
    with torch.enable_grad():
        r = rho0.detach().requires_grad_(True)
        a = r - 0.5
        lo = torch.where(a < -1e-12, a, -1e-12)
        e = torch.where(a < 0, torch.exp(-1.0 / (-lo)), torch.clamp(a, min=0.0) ** 1.5) * r ** (1 / 3)
        (gr,) = torch.autograd.grad((r * e).sum(), (r,))
    vout.copy_(gr)
    fo.copy_(torch.fft.ifftn(torch.fft.fftn(f, dim=(-3, -2, -1)), dim=(-3, -2, -1)))
    order = torch.argsort(ev, stable=True)
    occ.copy_(torch.zeros_like(ev).index_fill_(0, order[:100], 2.0))
    flag.copy_((it < 5) & (x.abs().max() > 0))
    flag_host.copy_(flag, non_blocking=True)
g = capture(body)
for i in range(5):
    g.replay(); torch.cuda.current_stream().synchronize()
    print('replay', i, 'it', int(it), 'flag', bool(flag_host))
print('solve residual', float((A @ x - rhs).abs().max()),
      'fft round trip', float((fo - f).abs().max()))
""",
}


def main():
    for name, body in PROBES.items():
        r = subprocess.run([sys.executable, "-c", SETUP + body], capture_output=True,
                           text=True, timeout=300)
        print(f"== {name}: exit code {r.returncode}")
        print(r.stdout[-2000:])
        if r.returncode:       # the errors raised, without the traceback frames
            print("\n".join(ln for ln in r.stderr.splitlines() if "Error" in ln))


if __name__ == "__main__":
    main()
